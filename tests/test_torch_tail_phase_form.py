"""The general K7's arithmetic (``csrc/decoder_tail_any.cu``), modelled in
numpy on the CPU at ragged widths.

The kernel runs only on a card (``chip_smoke.py``). What it does to the
weights and to the offset grid is modelled here, as it does it: the fold of
``fold_tail_weights_kernel`` with its index formulas written out, in its
layout (per chunk of 16 intermediate channels, Cin padded to a stage of 64
bytes, zeros for the channels beyond Cin and Cmid), held against the port's
``fold_kernel_2x`` and ``build_ky``; then the tail computed from those
padded weights over the kernel's tiles of 16 x 8 offset-grid entries (15 x
7 output entries and their halo, a chunk of intermediate channels at a
time, the border mask, the shifted reads of the output product), held in
f32 against the naive composition and the JAX package's plain tail within
1e-5 of the largest output.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strajnet_tpu.ops import pallas_decoder_tail as jtail
from strajnet_tpu_torch.ops import decoder_tail as dtl

torch.set_num_threads(2)
CM, NC, LANES = 16, 64, 8   # a chunk of Cmid, its 4 x 16 columns, Ky's lanes
TH, TW = 16, 8                     # offset-grid entries a tile
STAGE = {"float32": 16, "bfloat16": 32}   # input channels a stage: 64 bytes
# (N, H, W, Cin, Cmid): ragged widths, one tile and several
GEOMETRIES = {"cin5_cmid3": (2, 7, 9, 5, 3),
              "cin24_cmid20": (1, 17, 9, 24, 20)}


def _inputs(n, h, w, cin, cmid, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, k=1.0: (rng.randn(*s) * k).astype(np.float32)  # noqa: E731
    return [f(n, h, w, cin), f(3, 3, cin, cmid, k=0.3), f(cmid, k=0.1),
            f(3, 3, cmid, 2, k=0.3), f(2, k=0.1)]


def _fold_as_the_kernel(w_up, w_out, stage):
    """Kf [chunks, 4, 64, Cin padded to ``stage``] and Ky [chunks, 4, 64,
    8], by the formulas of ``fold_tail_weights_kernel``."""
    cin, cmid = w_up.shape[2:]
    cinp, chunks = -(-cin // stage) * stage, -(-cmid // CM)

    def first(a, u):
        return 0 if u == 0 else (1 if a == 0 else 2)

    def last(a, u):
        return (0 if a == 0 else 1) if u == 0 else 2

    kf = np.zeros((chunks, 4, NC, cinp), np.float32)
    ky = np.zeros((chunks, 4, NC, LANES), np.float32)
    for cm in range(chunks):
        for tap in range(4):
            u, v = tap >> 1, tap & 1
            for col in range(NC):
                p, co = col // CM, cm * CM + col % CM
                a, b = p >> 1, p & 1
                if co >= cmid:
                    continue
                for dy in range(first(a, u), last(a, u) + 1):
                    for dx in range(first(b, v), last(b, v) + 1):
                        kf[cm, tap, col, :cin] += w_up[dy, dx, :, co]
            for ch in range(NC):
                p2, mc = ch // CM, cm * CM + ch % CM
                a2, b2 = p2 >> 1, p2 & 1
                for lane in range(LANES):
                    q, o = lane >> 1, lane & 1
                    a, b = q >> 1, q & 1
                    kr, kc = 2 * u - a2 - a + 1, 2 * v - b2 - b + 1
                    if 0 <= kr <= 2 and 0 <= kc <= 2 and mc < cmid:
                        ky[cm, tap, ch, lane] = w_out[kr, kc, mc, o]
    return kf, ky


def _tail_as_the_kernel(x, w_up, b_up, w_out, b_out, stage):
    """The tail from the padded weights, tile by tile, in f32."""
    n, h, w, cin = x.shape
    cmid = w_up.shape[3]
    kf, ky = _fold_as_the_kernel(w_up, w_out, stage)
    chunks, cinp = kf.shape[0], kf.shape[3]
    out = np.zeros((n, 2 * h, 2 * w, 2), np.float32)
    xp = np.zeros((n, h + TH + 2, w + TW + 2, cinp), np.float32)
    xp[:, 1:h + 1, 1:w + 1, :cin] = x    # pixel (y, x) at (y + 1, x + 1)
    er, ec = np.divmod(np.arange(TH * TW), TW)  # a tile's entries
    for r0 in range(0, h, TH - 1):
        for c0 in range(0, w, TW - 1):
            r, c = r0 + er, c0 + ec                   # offset-grid entries
            acc = np.zeros((n, TH * TW, LANES), np.float32)
            for cm in range(chunks):
                y = np.zeros((n, TH * TW, NC), np.float32)
                for tap in range(4):
                    u, v = tap >> 1, tap & 1
                    y += xp[:, r + u, c + v] @ kf[cm, tap].T
                col = np.arange(NC)
                p, ch = col // CM, cm * CM + col % CM
                a2, b2 = (p >> 1)[None], (p & 1)[None]
                rr, cc = r[:, None], c[:, None]
                inside = ((rr <= h) & (cc <= w) & (ch[None] < cmid)
                          & ~((rr == 0) & (a2 == 1))
                          & ~((rr == h) & (a2 == 0))
                          & ~((cc == 0) & (b2 == 1))
                          & ~((cc == w) & (b2 == 0)))
                bias = np.where(ch < cmid, b_up[np.minimum(ch, cmid - 1)], 0)
                z = y + bias
                e = np.where(inside, np.where(z > 0, z, np.expm1(z)), 0)
                e = np.concatenate([e, np.zeros((n, 16, NC), np.float32)], 1)
                for tap in range(4):
                    sh = (tap >> 1) * TW + (tap & 1)
                    acc += e[:, sh:sh + TH * TW] @ ky[cm, tap]
            for k in np.flatnonzero((er < TH - 1) & (ec < TW - 1)
                                    & (r < h) & (c < w)):
                i, j = r[k], c[k]
                o = acc[:, k].reshape(n, 2, 2, 2) + b_out
                out[:, 2 * i:2 * i + 2, 2 * j:2 * j + 2] = o
    return out


@pytest.mark.parametrize("layout", sorted(STAGE))
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_padded_weights_match_the_ports_fold(geometry, layout):
    n, h, w, cin, cmid = GEOMETRIES[geometry]
    _, w_up, _, w_out, _ = _inputs(n, h, w, cin, cmid)
    kf, ky = _fold_as_the_kernel(w_up, w_out, STAGE[layout])
    fold = dtl.fold_kernel_2x(torch.from_numpy(w_up)).numpy()
    kyp = dtl.build_ky(torch.from_numpy(w_out)).numpy()
    for cm in range(kf.shape[0]):
        for tap in range(4):
            u, v = tap >> 1, tap & 1
            for p in range(4):
                for m in range(CM):
                    co, col = cm * CM + m, p * CM + m
                    if co < cmid:
                        np.testing.assert_allclose(
                            kf[cm, tap, col, :cin],
                            fold[u, v, :, p * cmid + co], rtol=1e-6,
                            atol=1e-6)
                        np.testing.assert_array_equal(
                            ky[cm, tap, col], kyp[u, v, p * cmid + co])
                    else:
                        assert not kf[cm, tap, col].any()
                        assert not ky[cm, tap, col].any()
    assert not kf[:, :, :, cin:].any()


@pytest.mark.parametrize("layout", sorted(STAGE))
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_tail_from_the_padded_weights_matches_the_plain_tails(geometry,
                                                              layout):
    n, h, w, cin, cmid = GEOMETRIES[geometry]
    args = _inputs(n, h, w, cin, cmid, seed=1)
    got = _tail_as_the_kernel(*args, STAGE[layout])
    ref = dtl.decoder_tail_reference(*[torch.from_numpy(a)
                                       for a in args]).numpy()
    xla = np.asarray(jtail.decoder_tail_xla(*[jnp.asarray(a) for a in args]))
    assert got.shape == ref.shape == (n, 2 * h, 2 * w, 2)
    for want in (ref, xla):
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * scale
