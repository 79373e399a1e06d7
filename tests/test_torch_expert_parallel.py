"""The port's expert parallelism (``wrinklefree_tpu_torch/parallel/
expert.py`` on ``torch.distributed``) against the JAX package's, on the
CPU.

``tests/test_expert_parallel.py``'s cases on the tiny configuration: its
bucketing cases as plain function tests (and against the reference's
``_bucket_assignments``), its three equivalence cases (no drops against the
dense dispatch, the identity-router oracle, a tight capacity), each at ep 1
(an expert axis of one in this process), 2 and 4 (gloo worlds of spawned
ranks, ``tests/_torch_dist.py::expert_cases``, each world once for the
module) against the reference's ``make_ep_moe`` / ``ep_moe_ffn`` on as many
of the 8 virtual CPU devices, on the same experts, router and tokens.

Tolerances and their ground:

- y against the reference's: the reference test's own 8e-3 absolute. The
  integer dots are exact in both; XLA's jitted expert evaluates its bf16
  elementwise chain (``relu(gate)**2 * up``, the sub-norm) with fewer
  roundings than the eager ops the port runs, which moves an output by a
  bf16 unit here and there (1-2 units of 2^-8 on these values);
- aux against the reference's: 1e-6 (the same routing, f32 means over the
  same rows);
- y against the port's dense ``moe_ffn`` (no drops), across ep 1, 2 and 4
  (no drops), and the identity oracle against the port's dense expert:
  none (bitwise). Each token's expert rows are row-independent: per-row
  quantization, exact integer dots, per-row rescale and norm; the combine
  rounds the same f32 sum of the same two products once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
import wrinklefree_tpu.models.moe as RM
from tests._torch_dist import ep_case, run_worlds
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.parallel import expert as re_
from wrinklefree_tpu_torch.models import moe as pm
from wrinklefree_tpu_torch.parallel.expert import _bucket_assignments, capacity_for
from wrinklefree_tpu_torch.parallel.sharding import Axis, NamedMesh

CFG = RefConfig.tiny()
I = CFG.intermediate_size


def _np(tree):
    return {k: np.array(v) for k, v in tree.items()}


def _case(E=8, T=32, seed=0, capacity_factor=8.0):
    experts, router = RM.init_moe_experts(CFG, E, seed=seed)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(T, CFG.hidden_size)), CFG.dtype)
    return dict(x=np.asarray(x, np.float32), experts=_np(experts), router=np.asarray(router),
                ffn_sub=np.ones((I,), np.float32), top_k=2, capacity_factor=capacity_factor,
                eps=CFG.rms_norm_eps)


def _identity_case():
    rng = np.random.default_rng(0)
    dense, _ = RM.init_moe_experts(CFG, 1, seed=1)
    x = jnp.asarray(rng.normal(size=(16, CFG.hidden_size)), CFG.dtype)
    E = 4
    experts = {k: np.repeat(np.array(v), E, axis=0) for k, v in dense.items()}
    return dict(x=np.asarray(x, np.float32), experts=experts,
                router=np.zeros((CFG.hidden_size, E), np.float32),
                ffn_sub=np.ones((I,), np.float32), top_k=1, capacity_factor=float(E),
                eps=CFG.rms_norm_eps, route=True)


# the reference test's three equivalence cases
CASES = {"no_drop": _case(), "identity": _identity_case(),
         "tight": _case(capacity_factor=0.25)}


@pytest.fixture(scope="module")
def port_out():
    worlds = run_worlds((2, 4), "expert_cases", CASES)
    mesh = NamedMesh({"expert": 1}, {"expert": Axis.local("expert")}, torch.device("cpu"),
                     "gloo")
    worlds[1] = [{"cases": {name: ep_case(mesh, c) for name, c in CASES.items()}}]
    return worlds


def _ref(name, ep):
    """The reference's y (f32 numpy) and aux for a case at ep devices."""
    c = CASES[name]
    mesh = Mesh(np.asarray(jax.devices()[:ep]), ("expert",))
    experts = {k: jnp.asarray(v) for k, v in c["experts"].items()}
    x = jnp.asarray(c["x"], CFG.dtype)
    sub = jnp.asarray(c["ffn_sub"], CFG.dtype)
    router = jnp.asarray(c["router"])
    if not c.get("route"):
        y, aux = re_.make_ep_moe(mesh, experts, sub, router, top_k=c["top_k"],
                                 capacity_factor=c["capacity_factor"], eps=c["eps"])(x)
        return np.asarray(y, np.float32), float(aux)

    def body(x, experts, sub, router):  # the reference test's identity oracle
        route = RM.identity_route(x.shape[0], 1, expert=0)
        return re_.ep_moe_ffn(x, experts, sub, router, ep_axis="expert", top_k=1,
                              capacity_factor=c["capacity_factor"], eps=c["eps"],
                              route_override=route)

    ex_specs = jax.tree.map(lambda _: P("expert"), experts)
    experts = jax.device_put(experts, jax.tree.map(lambda s: NamedSharding(mesh, s), ex_specs))
    fn = shard_map(body, mesh=mesh, in_specs=(P("expert"), ex_specs, P(), P()),
                   out_specs=(P("expert"), P()), check_rep=False)
    y, aux = jax.jit(fn)(jax.device_put(x, NamedSharding(mesh, P("expert"))), experts,
                         jax.device_put(sub, NamedSharding(mesh, P())),
                         jax.device_put(router, NamedSharding(mesh, P())))
    return np.asarray(y, np.float32), float(jnp.mean(aux))


def _port_tensors(c):
    return ({k: torch.from_numpy(v) for k, v in c["experts"].items()},
            torch.from_numpy(c["x"]).to(torch.bfloat16),
            torch.from_numpy(c["ffn_sub"]).to(torch.bfloat16), torch.from_numpy(c["router"]))


class TestBucketing:
    def test_capacity_formula(self):
        assert capacity_for(16, 2, 8, 1.0) == 4
        assert capacity_for(3, 1, 8, 1.0) == 1
        for args in ((32, 2, 8, 0.25), (1024, 2, 8, 8.0), (256, 2, 8, 0.25), (7, 3, 5, 1.3)):
            assert capacity_for(*args) == re_.capacity_for(*args), args

    def test_positions_unique_per_expert(self):
        top_i = torch.tensor([[0, 1], [0, 2], [0, 1], [3, 0]], dtype=torch.int32)
        pos, keep = _bucket_assignments(top_i, 4, capacity=8)
        # expert 0 receives 4 assignments in arrival order
        e0_pos = [int(pos[0, 0]), int(pos[1, 0]), int(pos[2, 0]), int(pos[3, 1])]
        assert e0_pos == [0, 1, 2, 3]
        assert bool(keep.all())
        rpos, rkeep = re_._bucket_assignments(jnp.asarray(top_i.numpy()), 4, capacity=8)
        assert np.array_equal(pos.numpy(), np.asarray(rpos))
        assert np.array_equal(keep.numpy(), np.asarray(rkeep))

    def test_overflow_dropped(self):
        top_i = torch.zeros((5, 1), dtype=torch.int32)  # all to expert 0
        pos, keep = _bucket_assignments(top_i, 2, capacity=3)
        assert int(keep.sum()) == 3
        assert not bool(keep[3, 0]) and not bool(keep[4, 0])
        rng = np.random.default_rng(3)
        top_i = rng.integers(0, 8, (64, 2)).astype(np.int32)
        pos, keep = _bucket_assignments(torch.from_numpy(top_i), 8, capacity=5)
        rpos, rkeep = re_._bucket_assignments(jnp.asarray(top_i), 8, capacity=5)
        assert np.array_equal(pos.numpy(), np.asarray(rpos))
        assert np.array_equal(keep.numpy(), np.asarray(rkeep))


class TestEPEquivalence:
    def test_ep_matches_dense_dispatch(self, port_out):
        """All-to-all EP over 4 ranks == the port's dense-dispatch
        ``moe_ffn`` bit for bit (capacity large enough that nothing drops);
        aux, the mean of the ranks' own losses, within the reference test's
        0.1 of the whole batch's; 2 all-to-alls and 1 gather a call."""
        c = CASES["no_drop"]
        experts, x, sub, router = _port_tensors(c)
        y_ref, aux_ref = pm.moe_ffn(x, experts, sub, router, top_k=2, eps=c["eps"])
        for r in port_out[4]:
            y, aux, calls = r["cases"]["no_drop"]
            assert np.array_equal(y, y_ref.float().numpy())
            assert abs(aux - float(aux_ref)) < 0.1
            assert calls == {"all_to_all": 2, "psum": 1, "all_gather": 1}

    def test_ep_identity_router_oracle(self, port_out):
        """The fake-MoE identity oracle survives the all-to-all path: every
        token routed to expert 0 (rank 0's) over 4 ranks == the dense FFN,
        bit for bit."""
        c = CASES["identity"]
        experts, x, sub, _ = _port_tensors(c)
        dense = pm._expert_ffn(x, {k: v[0] for k, v in experts.items()}, sub, c["eps"])
        for r in port_out[4]:
            y, _, _ = r["cases"]["identity"]
            assert np.array_equal(y, dense.float().numpy())

    def test_capacity_drops_degrade_gracefully(self, port_out):
        """Tiny capacity: the output stays finite and differs from the
        no-drop result (tokens lose expert contributions, no crash)."""
        for r in port_out[4]:
            y, _, _ = r["cases"]["tight"]
            assert np.isfinite(y).all()
            assert not np.allclose(y, r["cases"]["no_drop"][0], atol=8e-3, rtol=0)


@pytest.mark.parametrize("ep", [1, 2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_ep_matches_reference(port_out, name, ep):
    """Every rank's y within 8e-3 of the reference's at the same ep, aux
    within 1e-6 (module docstring)."""
    y_ref, aux_ref = _ref(name, ep)
    for r in port_out[ep]:
        y, aux, _ = r["cases"][name]
        assert y.shape == y_ref.shape
        np.testing.assert_allclose(y, y_ref, atol=8e-3, rtol=0)
        assert abs(aux - aux_ref) <= 1e-6


@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("name", ["no_drop", "identity"])
def test_ep_bitwise_across_ep(port_out, name, ep):
    """Tolerance: none. Without drops y at ep 2 and 4 equals ep 1's on every
    rank (a tight capacity drops other assignments at each ep: its C is
    taken from each rank's own token count)."""
    (one,) = port_out[1]
    for r in port_out[ep]:
        assert np.array_equal(r["cases"][name][0], one["cases"][name][0])


@pytest.mark.parametrize("ep", [2, 4])
def test_ep_raises(port_out, ep):
    """Experts, then tokens, that ep does not divide raise ``ValueError``."""
    for r in port_out[ep]:
        assert "not divisible by expert size" in (r["errors"]["experts"] or "")
        assert "not divisible by expert size" in (r["errors"]["tokens"] or "")
