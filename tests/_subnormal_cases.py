"""fp16 attention inputs whose output is carried by probabilities that fp16
holds only as subnormals, for K4 and K6 against their plain versions.

Only component 0 of the queries is set, so each key's score is its
component 0 times the scaled query. A dominant key (value row 0) sets each
row's max; every other key scores 10-14.5 units below it, so its
probability exp(s - max) lies in [5e-7, 4.6e-5], below fp16's least normal
2^-14, and its value row is +-1000 .. +-2000 with one sign per dim: the
output is sum(p v) / l over the subnormal probabilities alone. A kernel
that flushed them to zero would return zeros, and one that read the keys
at bf16 (2^-9 of component 0, up to 0.04 units of score) would move the
output by several percent.

K4 takes one dominant key, the first of each row's history: its kernel
keeps one running max per query row, and its plain softmax normalizes
before rounding, so with l near 1 both round the same probabilities to
fp16. K4's kernel scales q in fp16 and its plain version scales the f32
scores, so the query's value is the fp16 c in [8, 16) whose scaled form
fp16(c * fp16(1/sqrt(128))) is nearest c / sqrt(128) (2.4e-7 apart): the
scores then agree to f32 rounding. K6 keeps one running max per warp over
its 16 rows of each tile and rounds unnormalized probabilities in both
versions: a dominant key every 16 rows gives every warp the same max.
"""

import torch

D = 128
S_DOM = 20.0  # the dominant keys' score
DELTA = (10.0, 14.5)  # the other keys' scores below it
V_ABS = (1000.0, 2000.0)  # the other keys' values, one sign per dim


def k4_query_value() -> float:
    """The fp16 c in [8, 16) whose fp16 product with fp16(1/sqrt(D)) is
    nearest c / sqrt(D)."""
    c = torch.arange(8.0, 16.0, 2.0 ** -7).half()
    scaled = (c * torch.tensor(D ** -0.5, dtype=torch.float16)).float()
    return float(c[((scaled / (c.float() * D ** -0.5)) - 1).abs().argmin()])


def _keys_values(gen, n, dominant, qs0, sign, device):
    """k, v [n, D] in f32: rows where ``dominant`` is true score S_DOM, the
    rest S_DOM - DELTA; values 0 on the dominant rows."""
    k = torch.randn((n, D), generator=gen, device=device)
    delta = DELTA[0] + (DELTA[1] - DELTA[0]) * torch.rand(n, generator=gen, device=device)
    k[:, 0] = torch.where(dominant, S_DOM, S_DOM - delta) / qs0
    v = sign * (V_ABS[0] + (V_ABS[1] - V_ABS[0]) * torch.rand((n, D), generator=gen,
                                                              device=device))
    v[dominant] = 0.0
    return k, v


def k4_case(device, seed, *, b, s, kv, g, ps, mp, n_l):
    """(q, k_cur, v_cur, main, page_table) of fp16 K4 inputs: the first
    history token of each row dominant on every layer, every other
    history and chunk key subnormal; the page table a permutation of pages
    1..b*mp."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c = k4_query_value()
    qs0 = float((torch.tensor(c, dtype=torch.float16)
                 * torch.tensor(D ** -0.5, dtype=torch.float16)).float())
    sign = torch.where(torch.rand(D, generator=gen, device=device) < 0.5, -1.0, 1.0)
    q = torch.zeros((b, s, kv * g, D), device=device)
    q[..., 0] = c
    main = torch.zeros((b * mp + 1, 2 * n_l, ps, kv * D), device=device)
    pt = (torch.randperm(b * mp, generator=gen, device=device) + 1).reshape(b, mp)
    first = torch.arange(mp * ps, device=device) == 0
    for i in range(b):
        for layer in range(n_l):
            for h in range(kv):
                k, v = _keys_values(gen, mp * ps, first, qs0, sign, device)
                main[pt[i], layer, :, h * D:(h + 1) * D] = k.reshape(mp, ps, D)
                main[pt[i], n_l + layer, :, h * D:(h + 1) * D] = v.reshape(mp, ps, D)
    none = torch.zeros(b * s * kv, dtype=torch.bool, device=device)
    kc, vc = _keys_values(gen, b * s * kv, none, qs0, sign, device)
    return (q.half(), kc.reshape(b, s, kv, D).half(), vc.reshape(b, s, kv, D).half(),
            main.half(), pt.to(torch.int32))


def k6_case(device, seed, *, b, kv, g, ps, mp, n_l):
    """(q, k_cur, v_cur, main, staging, page_table) of K6 inputs: a bf16
    query, fp16 pool and staging pages whose every 16th token (from the
    first) is dominant, the rest subnormal; the current token's key and
    value zero (its probability below fp16's least subnormal)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.zeros((b, kv * g, D), device=device)
    q[..., 0] = 16.0
    q = q.bfloat16()
    qs0 = float((q[0, 0, 0] * torch.tensor(D ** -0.5, dtype=torch.bfloat16)).float())
    sign = torch.where(torch.rand(D, generator=gen, device=device) < 0.5, -1.0, 1.0)
    main = torch.zeros((b * mp + 1, 2 * n_l, ps, kv * D), device=device)
    stage = torch.zeros((b, ps, 2 * n_l, kv * D), device=device)
    pt = (torch.randperm(b * mp, generator=gen, device=device) + 1).reshape(b, mp)
    n = (mp + 1) * ps
    every16 = torch.arange(n, device=device) % 16 == 0
    for i in range(b):
        for layer in range(n_l):
            for h in range(kv):
                k, v = _keys_values(gen, n, every16, qs0, sign, device)
                cols = slice(h * D, (h + 1) * D)
                main[pt[i], layer, :, cols] = k[:mp * ps].reshape(mp, ps, D)
                main[pt[i], n_l + layer, :, cols] = v[:mp * ps].reshape(mp, ps, D)
                stage[i, :, layer, cols] = k[mp * ps:]
                stage[i, :, n_l + layer, cols] = v[mp * ps:]
    zero = torch.zeros((b, kv, D), dtype=torch.bfloat16, device=device)
    return q, zero, zero.clone(), main.half(), stage.half(), pt.to(torch.int32)


def subnormal_share(qs, k, valid):
    """(share, spread) of the scores ``qs @ k^T`` (f32; ``qs`` [R, D] scaled
    queries, ``k`` [T, D] keys, the first ``valid`` of them visible to every
    row): the share of their probabilities exp(s - row max) that fp16 holds
    only as subnormals, in [2^-24, 2^-14), and the least spread max - min of
    a row."""
    sc = qs.float() @ k[:valid].float().T
    p = torch.exp(sc - sc.amax(dim=1, keepdim=True))
    spread = float((sc.amax(dim=1) - sc.amin(dim=1)).min())
    return float(((p >= 2.0 ** -24) & (p < 2.0 ** -14)).float().mean()), spread


def keys_at_bf16(pages, n_l, dim=1):
    """Pool pages (``dim`` 1) or staging pages (``dim`` 2) with their key
    rows (layers 0..n_l-1 on ``dim``) rounded to bf16 and back: the read of
    the keys that an inexact kernel would make."""
    out = pages.clone()
    keys = out.narrow(dim, 0, n_l)
    keys.copy_(keys.bfloat16().to(pages.dtype))
    return out
