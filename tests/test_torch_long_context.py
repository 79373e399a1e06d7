"""Long context in the port (``wrinklefree_tpu_torch/engine/long_context.py``:
ring-attention prefill + context-parallel decode on ``torch.distributed``)
against the JAX package's ``LongContextEngine``, on the CPU.

The tiny f32 configuration of ``tests/test_long_context.py`` on the
reference's ``init_params(seed=0)`` weights, carried over with
``weights.params_from_numpy``. The port runs on gloo worlds of 1, 2 and 4
spawned ranks (``tests/_torch_dist.py``, each world once for the module,
every case in it); the reference on as many virtual CPU devices. Tokens
must be identical: to the reference's at the same P (a 37-token prompt, the
q-chunked prefill, a prompt whose length is no multiple of P, 16384 tokens
at P 4), and to the dense forward of both packages. The port chunks every
``s_loc > PREFILL_Q_CHUNK`` (the reference only multiples of the chunk;
ROADMAP "Avoided in the port"), so a ragged chunking is held to the
unchunked run's tokens and to the reference's. The port's ``Engine`` with
a group serves prompts of ``max_context`` tokens or more through the ring
path (greedy only; without a group they still raise), and
``create_server(long_context=True)`` serves them over HTTP on the group of
one it forms; ``bench/long_context.py`` runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from tests._torch_dist import run_worlds
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.engine.long_context import LongContextEngine as RefLCE
from wrinklefree_tpu.models.bitnet import KVCache as RefKVCache
from wrinklefree_tpu.models.bitnet import forward as ref_forward
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu_torch.config import BitNetConfig
from wrinklefree_tpu_torch.engine.long_context import LongContextEngine
from wrinklefree_tpu_torch.models.bitnet import KVCache, forward
from wrinklefree_tpu_torch.weights import params_from_numpy

WORLDS = (1, 2, 4)
CFG_KW = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=32, max_position=32768)
REF_CFG = RefConfig(**CFG_KW, dtype=jnp.float32)
CFG = BitNetConfig(**CFG_KW, dtype=torch.float32)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, CFG_KW["vocab_size"], size=n).tolist()


# name: (prompt, max_new_tokens, PREFILL_Q_CHUNK or None, world sizes)
CASES = {
    "dense": (_prompt(0, 37), 8, None, WORLDS),
    "qchunk": (_prompt(3, 64), 6, 8, WORLDS),  # s_loc 64/32/16: multiples of 8
    "qchunk_unchunked": (_prompt(3, 64), 6, None, WORLDS),
    "ragged": (_prompt(5, 50), 6, 8, WORLDS),  # s_loc 50/25/13: a shorter last chunk
    "ragged_unchunked": (_prompt(5, 50), 6, None, WORLDS),
    "not_multiple": (list(range(1, 14)), 4, None, WORLDS),
    "long_16k": (_prompt(1, 16384), 4, None, (4,)),
}
LONG_PROMPT = list(range(1, 100))  # >= the engine's max_context 64
SERVER_TEXT = "The long prompt. " * 18  # 306 bytes >= the tiny server's max_context 256


@pytest.fixture(scope="module")
def ref_params():
    return ref_init(REF_CFG, seed=0, fast=False)


@pytest.fixture(scope="module")
def np_params(ref_params):
    return jax.tree.map(np.asarray, ref_params)


@pytest.fixture(scope="module")
def port_out(np_params):
    payload = dict(params=np_params, cfg=CFG_KW, cases=CASES, long_prompt=LONG_PROMPT,
                   ids=_prompt(9, 300), text=SERVER_TEXT, gate_prompt=_prompt(5, 50))
    return run_worlds(WORLDS, "long_context_module", payload)


def _mesh(n):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("seq",))


def _ref_tokens(ref_params, world, prompt, n_new, chunk=None):
    eng = RefLCE(ref_params, REF_CFG, _mesh(world))
    if chunk is not None:
        eng.PREFILL_Q_CHUNK = chunk
    return eng.generate(prompt, max_new_tokens=n_new)


def _port_tokens(port_out, world, name):
    """Rank 0's tokens of a case, after checking every rank returned them."""
    ranks = port_out[world]
    toks = ranks[0]["lce"][name][0]
    assert all(r["lce"][name][0] == toks for r in ranks[1:])
    return toks


REF_CASES = [(name, w) for name in ("dense", "qchunk", "ragged", "not_multiple", "long_16k")
             for w in CASES[name][3]]


@pytest.mark.parametrize("name,world", REF_CASES)
def test_tokens_match_reference(port_out, ref_params, name, world):
    prompt, n_new, chunk, _ = CASES[name]
    got = _port_tokens(port_out, world, name)
    want = _ref_tokens(ref_params, world, prompt, n_new, chunk)
    assert len(got) == n_new and got == want, (got, want)
    t = port_out[world][0]["lce"][name][1]
    assert t["prompt_tokens"] == len(prompt) and t["decode_tokens"] == n_new - 1


@pytest.mark.parametrize("world", WORLDS)
def test_matches_dense_forward(port_out, ref_params, np_params, world):
    """Ring prefill + 7 decode steps == the dense forward's greedy tokens,
    the reference's and the port's (f32)."""
    prompt, n_new, _, _ = CASES["dense"]

    def dense(fwd, cache, tok, zero, pos):
        logits, cache = fwd(cache, tok([prompt]), zero)
        out = [int(np.asarray(logits)[0, -1].argmax())]
        p = len(prompt)
        for _ in range(n_new - 1):
            logits, cache = fwd(cache, tok([[out[-1]]]), pos(p))
            out.append(int(np.asarray(logits)[0, -1].argmax()))
            p += 1
        return out

    want = dense(lambda c, t, s: ref_forward(ref_params, REF_CFG, t, c, s),
                 RefKVCache.zeros(REF_CFG, 1, 64), lambda x: jnp.asarray(x, jnp.int32),
                 jnp.zeros((1,), jnp.int32), lambda p: jnp.asarray([p], jnp.int32))
    params = params_from_numpy(np_params, CFG, device="cpu")
    port_dense = dense(lambda c, t, s: forward(params, CFG, t, c, s),
                       KVCache.zeros(CFG, 1, 64, device="cpu"), torch.tensor,
                       torch.zeros((1,), dtype=torch.int32), lambda p: torch.tensor([p]))
    got = _port_tokens(port_out, world, "dense")
    assert got == want == port_dense, (got, want, port_dense)


@pytest.mark.parametrize("name", ["qchunk", "ragged"])
@pytest.mark.parametrize("world", WORLDS)
def test_qchunked_prefill_matches_unchunked(port_out, world, name):
    """The blockwise-q ring prefill (PREFILL_Q_CHUNK = 8) gives the
    unchunked prefill's tokens: chunks that divide s_loc, and a shorter last
    chunk (where the reference would attend unchunked)."""
    assert (_port_tokens(port_out, world, name)
            == _port_tokens(port_out, world, f"{name}_unchunked"))


@pytest.mark.parametrize("world", WORLDS)
def test_engine_routes_long_prompts(port_out, ref_params, world):
    """Engine.generate serves a 99-token prompt (>= max_context 64) through
    the ring path, with the reference's tokens; a short prompt still takes
    the paged engine."""
    for rank in port_out[world]:
        long_ids, finished, reason, n_req = rank["engine"]["long"]
        assert finished and reason == "length" and n_req == 1
        assert long_ids == _ref_tokens(ref_params, world, LONG_PROMPT, 4)
        short_ids, short_fin, prefilled = rank["engine"]["short"]
        assert short_fin and len(short_ids) == 4 and prefilled == 3


@pytest.mark.parametrize("case,match", [
    ("sampling", "greedy-only"),  # the ring path takes no sampling
    ("no_group", "prompt too long"),  # without a group, long prompts still raise
    ("fused", "unfused"),  # the ring path's snapshot is of unfused params
])
def test_engine_long_context_refusals(port_out, case, match):
    for world in WORLDS:
        err = port_out[world][0]["engine"]["errors"][case]
        assert err is not None and match in err, err


def test_create_server_long_context(port_out):
    """create_server(long_context=True) forms a group of one and serves a
    greedy prompt beyond max_context: the same tokens through
    Engine.generate, the async route and HTTP; a sampled one is a 400."""
    s = port_out[1][0]["server"]
    assert s["world"] == (True, 1)
    assert len(SERVER_TEXT) >= s["max_context"] and len(s["direct"]) == 4
    assert s["async"] == (s["direct"], True)
    status, body = s["http"]
    assert status == 200 and body["tokens_predicted"] == 4
    assert body["content"] == "".join(chr((i - 1) % 250) if i > 0 else ""
                                      for i in s["http_ids"])
    assert s["http_sampled"][0] == 400 and "too long" in s["http_sampled"][1]["error"]


def test_long_route_beside_the_scheduler(port_out):
    """The async route runs a long prompt on its executor thread while a
    short stream runs on the scheduler thread: each gets the tokens it gets
    alone, for each of two short prompts. With two replicas, the long
    prompt goes to replica 0, which holds the group, when the router would
    pick replica 1."""
    s = port_out[1][0]["server"]
    assert s["together"] == [[s["direct"], short] for short in s["short_direct"]]
    assert s["dp2_pick"] == 1
    assert s["dp2"] == (s["direct"], [1, 0])


@pytest.mark.parametrize("world", [w for w in WORLDS if w > 1])
def test_long_context_refuses_a_multi_rank_server(port_out, world):
    """A default group of more than one rank: ``group_of_one`` and
    ``create_server(long_context=True)`` raise (the ring path is collective,
    and nothing brings the other ranks to a request)."""
    for rank in port_out[world]:
        for name, err in rank["multi_rank"].items():
            assert err is not None and f"{world} ranks" in err, (name, err)


def test_f32_gate_on_the_cpu(port_out):
    """``chip_smoke.py``'s f32 gate of the long-context path on the tiny
    model: every layer's ring attention within its tolerance of the dense
    one, the ring logits bitwise the hybrid's, tokens equal to the dense
    forward's, and both controls (a dropped prefix key, a prefix V out of
    step with its K) caught, each by the check meant for it."""
    from chip_smoke import LONGCTX_ATTN_TOL

    rep, failures = port_out[1][0]["gate"]
    assert failures == [], failures
    assert rep["attn_err"] <= LONGCTX_ATTN_TOL and rep["hybrid_err"] == 0.0
    assert rep["part"] is None and rep["tokens"] == rep["dense_tokens"]
    drop, shift = rep["controls"]["drop_top_key"], rep["controls"]["shifted_prefix"]
    assert any("attention differs" in f for f in drop), drop
    assert any("hybrid" in f for f in shift), shift


def test_f32_gate_on_a_ring_of_two(port_out):
    """The same gate on a group of two ranks (a tensor-parallel engine's
    ring): on each rank, every layer's ring attention (this rank's rows over
    both ranks' keys) within its tolerance of the dense one, the ring logits
    bitwise those of the dense forward run on this rank's rows with the
    ring's attention, tokens equal to the dense forward's; its control, the
    last rank's prefix block dropped from the decode's merge, caught by the
    attention check."""
    from chip_smoke import LONGCTX_ATTN_TOL

    for rep, failures in (r["gate"] for r in port_out[2]):
        assert failures == [], failures
        assert rep["ranks"] == 2 and rep["attn_err"] <= LONGCTX_ATTN_TOL
        assert rep["hybrid_err"] == 0.0
        assert rep["part"] is None and rep["tokens"] == rep["dense_tokens"]
        c = rep["controls"]
        assert list(c) == ["dropped_block"], c
        assert any("attention differs" in f for f in c["dropped_block"]), c


def test_long_context_bench_on_the_cpu(port_out):
    """``bench/long_context.py`` runs the tiny model on the CPU: a 300-token
    prompt and 4 greedy tokens; its device fields are null (not measured)."""
    r = port_out[1][0]["bench"]
    assert (r["model"], r["prompt_tokens"], r["new_tokens"], r["device"]) == ("tiny", 300, 4,
                                                                            "cpu")
    assert r["prefill_s"] > 0 and r["decode_ms_per_token"] > 0
    assert all(r[k] is None for k in ("peak_gb", "decode_device_ms_per_step",
                                      "decode_device_ops_per_step",
                                      "decode_top_kernels_ms_per_step"))


def test_long_context_engine_defaults_to_the_card(np_params):
    """Without device="cpu" the engine asks for CUDA, which this host lacks;
    on the CPU it needs a group (torch.distributed is not initialized
    here)."""
    params = params_from_numpy(np_params, CFG, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LongContextEngine(params, CFG)
    with pytest.raises(ValueError, match="not initialized"):
        LongContextEngine(params, CFG, device="cpu")
