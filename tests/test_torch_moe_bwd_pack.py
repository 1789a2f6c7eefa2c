"""The packed layout of ``moe_gemm_bwd`` on the CPU, and the kernels' build
hash.

``csrc/moe_gemm_bwd.cu`` first packs, for each weight row e, the live rows
of every slot that names e into one segment, slots ascending and rows in
order, padded to a multiple of ``moe_gemm.PACK_TILE`` rows; every product
then runs over contiguous segments. ``ref.moe_bwd_pack_plain`` is the
layout's plain mirror (the CUDA test in ``test_torch_moe_gemm_bwd_cuda.py``
holds the device's index against it). Here the mirror is held against
``live_rows_mask`` and the slot map: every live row exactly once, slot order
inside a segment, each segment padded to the tile with -1 rows, dead rows
and slots outside [0, E) absent, the 128-row tiles covering the segments.
The kernels' arithmetic over that layout (zero rows in the padding, weight
sums over whole segments) is replayed in fp32 and held against
``moe_gemm_bwd_plain`` within 1e-5 (the same sums in another order).

``build.library_path`` hashes every ``csrc/*.cuh`` beside the source: an
edited shared header changes both libraries' paths.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402

# (S, T, E, B, slot map, counts): counts None means every row live
LAYOUTS = {
    "shared_experts": (5, 12, 4, 3, [0, 2, 0, 1, 2], "random"),
    "out_of_range": (4, 10, 3, 2, [0, -1, 3, 1], "random"),
    "replicas": (6, 8, 4, 1, [0, 1, 2, 3, 0, 2], None),
    "segment_64_65": (4, 80, 3, 2, [0, 1, 1, 2],
                      [[40, 24], [40, 0], [20, 5], [0, 0]]),
    "wide_e": (128, 8, 128, 4, list(range(128)), "random"),
    "unnamed_expert": (3, 20, 5, 4, [4, 4, 0], "random"),
}


def _layout(name, seed=0):
    S, T, E, B, se, counts = LAYOUTS[name]
    rng = np.random.default_rng(seed)
    if isinstance(counts, str):
        counts = rng.integers(0, T // B + 1, (S, B))
    se_t = torch.tensor(se, dtype=torch.int32)
    c_t = None if counts is None else torch.tensor(np.asarray(counts),
                                                   dtype=torch.int32)
    return S, T, E, se_t, c_t


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_pack_mirror_holds_every_live_row_once_in_slot_order(name):
    S, T, E, se, counts = _layout(name)
    lay = ref.moe_bwd_pack_plain(se, counts, T, E, tile=mg.PACK_TILE,
                                 tile_rows=mg.TILE_ROWS)
    live = (torch.ones((S, T), dtype=torch.bool) if counts is None
            else ref.live_rows_mask(counts, T))
    named = (se >= 0) & (se < E)
    want = sorted(int(s) * T + int(t) for s, t in live.nonzero().tolist()
                  if named[s])
    packed = lay["packed"]
    got = packed[packed >= 0].tolist()
    assert sorted(got) == want                       # each live row once
    seg_off, seg_n = lay["seg_off"], lay["seg_n"]
    assert int(seg_off[0]) == 0 and int(seg_off[-1]) == packed.numel()
    for e in range(E):
        lo, n = int(seg_off[e]), int(seg_n[e])
        hi = int(seg_off[e + 1])
        assert (hi - lo) % mg.PACK_TILE == 0 and hi - lo - n < mg.PACK_TILE
        assert (packed[lo + n:hi] == -1).all()       # padding rows
        rows = packed[lo:lo + n].tolist()
        assert all(r >= 0 and int(se[r // T]) == e for r in rows)
        assert rows == sorted(rows)                  # slots, then rows
        assert n == sum(int(live[s].sum()) for s in range(S)
                        if int(se[s]) == e)
    for s in range(S):
        n, at = int(lay["slot_n"][s]), int(lay["slot_start"][s])
        if not named[s]:
            assert n == 0
            continue
        assert packed[at:at + n].tolist() == [
            s * T + t for t in live[s].nonzero()[:, 0].tolist()]
    # the tiles cover each segment in TILE_ROWS steps, in order
    cover = []
    for row0, rows, e in lay["tiles"].tolist():
        assert int(seg_off[e]) <= row0 and row0 + rows <= int(seg_off[e + 1])
        assert rows % mg.PACK_TILE == 0 and 0 < rows <= mg.TILE_ROWS
        cover += list(range(row0, row0 + rows))
    assert cover == list(range(packed.numel()))
    assert packed.numel() <= mg.pack_rows_bound(S, T, E)
    assert len(lay["tiles"]) <= -(-mg.pack_rows_bound(S, T, E)
                                  // mg.PACK_TILE)


def _packed_bwd(x, w_gate, w_up, w_down, se, dy, act, counts):
    """The kernels' products over the packed layout in fp32: packed x and
    dy with zero padding rows, h / dg / du per packed row (rounded to x's
    dtype), dx scattered back by the packed list, and the weight sums
    over each whole padded segment."""
    S, T, d = x.shape
    E, _, F = w_up.shape
    lay = ref.moe_bwd_pack_plain(se, counts, T, E)
    rows = lay["packed"]
    keep = (rows >= 0)[:, None]
    src = rows.clamp_min(0)
    xp = torch.where(keep, x.reshape(S * T, d)[src].float(), 0.0)
    dyp = torch.where(keep, dy.reshape(S * T, d)[src].float(), 0.0)
    dx = torch.zeros(S * T, d)
    grads = {n: torch.zeros(w.shape) for n, w in
             (("g", w_up), ("u", w_up), ("d", w_down))}
    for e in range(E):
        lo, hi = int(lay["seg_off"][e]), int(lay["seg_off"][e + 1])
        xs, dys = xp[lo:hi], dyp[lo:hi]
        u = xs @ w_up[e].float()
        g = xs @ w_gate[e].float() if act == "swiglu" else None
        dh = dys @ w_down[e].float().T
        h, dg, du = (None if t is None else t.to(x.dtype).float()
                     for t in ref._hidden_grad(g, u, dh, act))
        dxs = du @ w_up[e].float().T
        if dg is not None:
            dxs = dg @ w_gate[e].float().T + dxs
            grads["g"][e] = xs.T @ dg
        live = rows[lo:hi] >= 0
        dx[rows[lo:hi][live]] = dxs[live]
        grads["u"][e] = xs.T @ du
        grads["d"][e] = h.T @ dys
    return (dx.reshape(S, T, d), grads["g"] if act == "swiglu" else None,
            grads["u"], grads["d"])


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu"])
@pytest.mark.parametrize("name", ["shared_experts", "out_of_range",
                                  "segment_64_65", "unnamed_expert"])
def test_packed_products_equal_plain_version(name, act):
    S, T, E, se, counts = _layout(name, seed=1)
    rng = np.random.default_rng(2)
    d, F = 8, 12
    x = torch.tensor(rng.normal(size=(S, T, d)) * 0.5, dtype=torch.float32)
    dy = torch.tensor(rng.normal(size=(S, T, d)) * 0.5, dtype=torch.float32)
    if counts is not None:                       # garbage in the dead rows
        dead = ~ref.live_rows_mask(counts, T)[..., None]
        x, dy = x.masked_fill(dead, 1e3), dy.masked_fill(dead, -1e3)
    w = [torch.tensor(rng.normal(size=s) * 0.3, dtype=torch.float32)
         for s in ((E, d, F), (E, d, F), (E, F, d))]
    args = (x, w[0] if act == "swiglu" else None, w[1], w[2], se, dy, act,
            counts)
    want = ref.moe_gemm_bwd_plain(*args)
    got = _packed_bwd(x, w[0], w[1], w[2], se, dy, act, counts)
    for name_, g, a in zip(("dx", "d_w_gate", "d_w_up", "d_w_down"), got,
                           want):
        if a is None:
            assert g is None
            continue
        assert torch.allclose(g, a, atol=1e-5, rtol=1e-5), name_


def test_library_path_hashes_every_shared_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("moe_gemm", "moe_gemm_bwd", "histogram")
    before = {n: build.library_path(n) for n in names}
    assert before == {n: build.library_path(n) for n in names}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    (csrc / "moe_gemm_bwd.cu").write_text(
        (csrc / "moe_gemm_bwd.cu").read_text() + "\n")
    again = {n: build.library_path(n) for n in names}
    assert again["moe_gemm_bwd"] != after["moe_gemm_bwd"]
    assert again["moe_gemm"] == after["moe_gemm"]
