"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the main path does not reach (ragged lengths, batch > 1,
fp32 flash attention, non-contiguous views, channel tails; the int8 conv K4
and the W8A8 linear; the kv-mask flash kernel K5 and the fp32 decode
convs; the count-driven sparse kernels K9a / K9b; the causal Wan training
masks of K1 struct / K6 struct; the Hopper schedule of the flash kernels
at its edges: ragged tiles and ring stages, strided views, heads of 64 and
128, struct borders inside 128-row tiles, K5's empty chunks, the split
dK/dV and its reduction, rows with no key; the sparse kernels' Hopper
schedule: K7 bwd's ragged units, empty tiles and -1 slots, K9's groups of
query tiles and ragged key units, the first schedule at other heads, and
an unaligned operand that raises; K1's wide schedule at a head of 384 and
its split merge, and K3's 3xTF32 form; K1's fp32 form at a head of 384 on
its 3xTF32 schedule, its pre-pass and its fp32 merge). Marked ``cuda``: they
skip without an sm_90 card. On the card
(which has no JAX, so without the suite's conftest):

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q
"""

import itertools

import pytest
import torch

from fastvideo_tpu_torch.ops import (_build, bsa, conv3d, flash_attention,
                                     nabla, vsa)
from fastvideo_tpu_torch.ops import sparse_schedule as ss

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, want, dtype, attention=True):
    # fp32: summation order only. bf16: both sides round to bf16, so two
    # ulps (2^-6) relative, plus a floor for values near zero where the
    # order of the fp32 sums shows. An attention output is a softmax average
    # of N random values, typically about N^-0.5 (0.09 to 0.2 here), so its
    # floor is 2^-5 of the plain output's std; a conv output here is of
    # order 1 and its floor is 1e-2.
    if dtype == torch.float32:
        atol, rtol = 1e-4, 1e-4
    elif attention:
        atol, rtol = 2.0**-5 * want.float().std().item(), 2.0**-6
    else:
        atol, rtol = 1e-2, 1.6e-2
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype,d,causal,kv_valid", [
    (torch.bfloat16, 64, False, None),
    (torch.bfloat16, 128, True, 100),
    (torch.bfloat16, 384, False, 60),
    (torch.float32, 64, True, None),
    (torch.float32, 384, False, 0),
    (torch.float32, 384, False, None),  # the VAE attention of an fp32 decode
])
def test_flash_matches_plain(dev, dtype, d, causal, kv_valid):
    g = torch.Generator(device=dev).manual_seed(0)
    b, sq, skv, h = 2, 77, 130, 3
    q = torch.randn(b, sq, h, d, generator=g, device=dev, dtype=dtype)
    # k/v as strided views of a wider buffer
    kv = torch.randn(b, skv, h, 2 * d, generator=g, device=dev, dtype=dtype)
    k, v = kv[..., :d], kv[..., d:]
    kw = dict(scale=d**-0.5, causal=causal, kv_valid=kv_valid)
    out, lse = flash_attention.flash_attention(q, k, v, return_lse=True,
                                               **kw)
    ref, ref_lse = flash_attention.flash_attention_plain(
        q, k, v, **dict(kw, kv_valid=skv if kv_valid is None else kv_valid))
    _close(out, ref, dtype)
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    torch.testing.assert_close(lse[finite], ref_lse[finite], atol=1e-3,
                               rtol=1e-4)


@pytest.mark.parametrize("e,nb,qg,topk,d", [
    (280, 9, 3, 4, 128),
    (64, 8, 1, 1, 128),
    (96, 6, 2, 6, 128),
    (280, 6, 3, 2, 64),
])
def test_vsa_sparse_matches_plain(dev, e, nb, qg, topk, d):
    g = torch.Generator(device=dev).manual_seed(1)
    b, h, dtype = 2, 3, torch.bfloat16
    q, k, v = (torch.randn(b, h, nb * e, d, generator=g, device=dev,
                           dtype=dtype) for _ in range(3))
    ng = nb // qg
    idx = torch.stack([torch.randperm(nb, generator=g, device=dev)[:topk]
                       for _ in range(b * h * ng)]).reshape(b, h, ng, topk)
    out = vsa.block_sparse_attention_fast(q, k, v, idx, tile_elems=e)
    ref = vsa.block_sparse_attention_plain(q, k, v, idx, scale=d**-0.5,
                                           tile_elems=e)
    _close(out, ref, dtype)


def _padded_case(dev, b, h, nb, e, d, topk, seed=3):
    """Random padded-tile inputs: partial tiles (garbage, even non-finite,
    in the padded key slots), ragged index rows with -1 sentinels."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, h, nb * e, d, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    sizes = torch.randint(1, e + 1, (nb,), generator=g, device=dev,
                          dtype=torch.int32)
    sizes[0] = e
    pad = (torch.arange(nb * e, device=dev) % e) >= sizes.repeat_interleave(e)
    k[:, :, pad] = float("nan")
    v[:, :, pad] = float("inf")
    idx = torch.stack([torch.randperm(nb, generator=g, device=dev)[:topk]
                       for _ in range(b * h * nb)]).reshape(b, h, nb, topk)
    keep = torch.randint(1, topk + 1, (b, h, nb, 1), generator=g, device=dev)
    idx = torch.where(torch.arange(topk, device=dev) < keep, idx, -1)
    return q, k, v, idx.to(torch.int32), sizes


def _plain_padded(q, k, v, idx, sizes, e, **kw):
    # the plain version multiplies masked probabilities (0) by the padded
    # values, so it gets the padded slots zeroed; the kernel never reads them
    pad = (torch.arange(q.shape[2], device=q.device) % e) >= \
        sizes.repeat_interleave(e)
    k, v = k.clone(), v.clone()
    k[:, :, pad] = 0
    v[:, :, pad] = 0
    return vsa.block_sparse_attention_plain(
        q, k, v, idx, sizes, scale=q.shape[-1]**-0.5, tile_elems=e, **kw)


@pytest.mark.parametrize("e,nb,topk,d", [
    (256, 7, 4, 128),   # the padded (4, 8, 8) VSA / STA tile
    (64, 9, 3, 128),    # SLA's tile
    (280, 5, 5, 64),    # a forced tile that is no multiple of the chunk
    (40, 6, 2, 32),     # a tile smaller than a query sub-block
])
def test_vsa_sparse_padded_matches_plain(dev, e, nb, topk, d):
    q, k, v, idx, sizes = _padded_case(dev, 2, 3, nb, e, d, topk)
    out, lse = vsa.block_sparse_attention(q, k, v, idx, sizes, tile_elems=e,
                                          return_lse=True)
    ref, ref_lse = _plain_padded(q, k, v, idx, sizes, e, return_lse=True)
    _close(out, ref, torch.bfloat16)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    # the same kernel without the LSE output, on strided operands
    qkv = torch.stack([q, k, v], dim=-2)  # [B, H, S, 3, D]
    out2 = vsa.block_sparse_attention(qkv[..., 0, :], qkv[..., 1, :],
                                      qkv[..., 2, :], idx, sizes,
                                      tile_elems=e)
    torch.cuda.synchronize()
    assert torch.equal(out2, out)


def test_vsa_sparse_padded_all_masked_rows_are_zero(dev):
    """A query tile whose every slot is a sentinel outputs exactly 0 and the
    finite empty-row LSE, never NaN."""
    e, nb = 64, 4
    q, k, v, idx, sizes = _padded_case(dev, 1, 2, nb, e, 64, 2)
    idx[:, :, 1] = -1
    out, lse = vsa.block_sparse_attention(q, k, v, idx, sizes, tile_elems=e,
                                          return_lse=True)
    ref, ref_lse = _plain_padded(q, k, v, idx, sizes, e, return_lse=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert (out[:, :, e:2 * e] == 0).all()
    assert (lse[:, :, e:2 * e] == vsa.MASK_VALUE).all()
    _close(out, ref, torch.bfloat16)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


def test_vsa_sparse_padded_rejects_grad_and_fp32(dev):
    q = torch.zeros(1, 1, 128, 64, device=dev, dtype=torch.bfloat16)
    idx = torch.zeros(1, 1, 2, 1, device=dev, dtype=torch.int32)
    sizes = torch.full((2,), 64, device=dev, dtype=torch.int32)
    with pytest.raises(_build.KernelError, match="bfloat16"):
        vsa.block_sparse_attention(q.float(), q.float(), q.float(), idx,
                                   sizes)
    qg = q.clone().requires_grad_()
    with pytest.raises(_build.KernelError, match="backward"):
        vsa.block_sparse_attention(qg, q, q, idx, sizes)
    with torch.no_grad():
        vsa.block_sparse_attention(qg, q, q, idx, sizes)


def test_sta_and_sla_launch_the_padded_kernel(dev):
    from fastvideo_tpu_torch.ops import sla, sta

    g = torch.Generator(device=dev).manual_seed(5)
    grid, tile, h, d = (5, 9, 11), (2, 4, 4), 2, 64
    s = grid[0] * grid[1] * grid[2]
    q, k, v = (torch.randn(1, s, h, d, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    windows = ((3, 3, 3), (1, 3, 5))
    before = _build.LAUNCHES["vsa_sparse_padded_fwd"]
    plain_before = dict(_build.PLAIN_CALLS)
    out = sta.sliding_tile_attention(q, k, v, grid, windows, tile)
    assert _build.LAUNCHES["vsa_sparse_padded_fwd"] == before + 1
    assert _build.PLAIN_CALLS == plain_before
    ref = sta.sliding_tile_attention(q.cpu(), k.cpu(), v.cpu(), grid, windows,
                                     tile)
    _close(out.cpu(), ref, torch.bfloat16)

    q, k, v = (torch.randn(1, 512, h, d, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    w = torch.randn(d, d, generator=g, device=dev) * d**-0.5
    out = sla.sla_attention(q, k, v, topk_ratio=0.4, proj_weight=w)
    assert _build.LAUNCHES["vsa_sparse_padded_fwd"] == before + 2
    ref = sla.sla_attention(q.cpu(), k.cpu(), v.cpu(), topk_ratio=0.4,
                            proj_weight=w.cpu())
    _close(out.cpu(), ref, torch.bfloat16)


@pytest.mark.parametrize("kt,time_pad,c,co", list(itertools.product(
    [1, 3], [0, 2], [8, 24], [3, 40, 72])))
def test_conv3d_matches_plain(dev, kt, time_pad, c, co):
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(2, 4, 5, 7, c, generator=g, device=dev,
                    dtype=torch.bfloat16)
    w = (torch.randn(kt, 3, 3, c, co, generator=g, device=dev) *
         (kt * 9 * c)**-0.5).to(torch.bfloat16)
    b = torch.randn(co, generator=g, device=dev).to(torch.bfloat16)
    out = conv3d.conv3d_ndhwc(x, w, b, time_pad=time_pad)
    ref = conv3d.conv3d_ndhwc_plain(x, w, b, time_pad=time_pad)
    assert out.shape == (2, 4 + time_pad - kt + 1, 5, 7, co)
    _close(out, ref, torch.bfloat16, attention=False)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.bfloat16, 256)])
def test_vsa_sparse_rejects_other_dtypes_and_head_dims(dev, dtype, d):
    q = torch.zeros(1, 1, 128, d, device=dev, dtype=dtype)
    idx = torch.zeros(1, 1, 2, 1, device=dev, dtype=torch.int32)
    with pytest.raises(_build.KernelError, match="bfloat16"):
        vsa.block_sparse_attention_fast(q, q, q, idx, tile_elems=64)


def test_wrappers_count_launches_not_plain(dev):
    q = torch.randn(1, 64, 1, 64, device=dev, dtype=torch.bfloat16)
    before = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    flash_attention.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_fwd"] == before[0]["flash_fwd"] + 1
    assert _build.PLAIN_CALLS == before[1]


def test_conv3d_gamma_raises_on_cuda(dev):
    x = torch.zeros(1, 2, 4, 4, 8, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 3, 8, 8, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(_build.KernelError, match="prologue"):
        conv3d.conv3d_ndhwc(x, w, b, time_pad=2, gamma=b)


def _int8_case(dev, bsz, t, h, w, c, co, kt, seed=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    xq = torch.randint(-127, 128, (bsz, t, h, w, c), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (kt, 3, 3, c, co), generator=g, device=dev,
                       dtype=torch.int8)
    scale = torch.rand(co, generator=g, device=dev) * 1e-4
    bias = torch.randn(co, generator=g, device=dev)
    return xq, wq, scale, bias


def _one_bf16_ulp(got, want):
    # the int32 sums are exact on both sides and the epilogue rounds the
    # same way, so they may differ by at most one bf16 ulp of the output
    torch.cuda.synchronize()
    ulp = 2.0**(torch.floor(torch.log2(want.float().abs().clamp_min(
        2.0**-126))) - 7)
    assert ((got.float() - want.float()).abs() <= ulp).all()


@pytest.mark.parametrize("bsz,c,co,kt,time_pad,w", [
    (1, 32, 32, 3, 2, 9),    # the smallest int8 route (kf_int8)
    (2, 64, 96, 1, 0, 13),   # Co = 96 with a ragged voxel tail, batch 2
    (2, 64, 96, 3, 2, 13),
    (1, 96, 192, 3, 0, 7),   # two column blocks
    (1, 192, 64, 1, 2, 5),   # a warp with n8 tiles past Co
])
def test_conv3d_int8_matches_plain(dev, bsz, c, co, kt, time_pad, w):
    xq, wq, scale, bias = _int8_case(dev, bsz, 3, 5, w, c, co, kt)
    before = dict(conv3d_int8=_build.LAUNCHES["conv3d_int8"]), dict(
        _build.PLAIN_CALLS)
    out = conv3d.conv3d_int8(xq, wq, scale, bias, time_pad=time_pad,
                             out_dtype=torch.bfloat16)
    assert _build.LAUNCHES["conv3d_int8"] == before[0]["conv3d_int8"] + 1
    assert _build.PLAIN_CALLS == before[1]
    ref = conv3d.conv3d_int8_plain(xq, wq, scale, bias, time_pad=time_pad,
                                   out_dtype=torch.bfloat16)
    assert out.shape == ref.shape == (bsz, 3 + time_pad - kt + 1, 5, w, co)
    _one_bf16_ulp(out, ref)


def test_conv3d_int8_takes_a_non_contiguous_input(dev):
    xq, wq, scale, bias = _int8_case(dev, 1, 4, 5, 6, 64, 64, 3)
    wide = torch.cat([xq, xq], dim=-1)[..., :64]  # strided channels
    out = conv3d.conv3d_int8(wide, wq, scale, bias, time_pad=2,
                             out_dtype=torch.bfloat16)
    ref = conv3d.conv3d_int8_plain(xq, wq, scale, bias, time_pad=2,
                                   out_dtype=torch.bfloat16)
    _one_bf16_ulp(out, ref)


def test_conv3d_int8_refuses_other_operands(dev):
    xq, wq, scale, bias = _int8_case(dev, 1, 2, 4, 4, 32, 32, 3)
    kw = dict(time_pad=2, out_dtype=torch.bfloat16)
    with pytest.raises(_build.KernelError, match="int8"):
        conv3d.conv3d_int8(xq.to(torch.bfloat16), wq, scale, bias, **kw)
    with pytest.raises(_build.KernelError, match="multiples of 32"):
        conv3d.conv3d_int8(xq[..., :16], wq[:, :, :, :16], scale, bias, **kw)
    with pytest.raises(_build.KernelError, match="bfloat16 or float32"):
        conv3d.conv3d_int8(xq, wq, scale, bias, time_pad=2,
                           out_dtype=torch.float16)


@pytest.mark.parametrize("mode", ["auto", "kf_int8"])
def test_fp32_decode_convs_raise_on_cuda(dev, mode):
    # vae_decode_precision="fp32" decodes in fp32, as the JAX package's
    # kernels do: K3 takes fp32 operands and K4 writes fp32. Once this test
    # held that such a decode raised on the card; it now holds both kernels
    # to the CPU's plain version: K3 within fp32 summation order, K4 bit
    # for bit (exact int32 sums, the same quantized operands, the same
    # rounding in the epilogue).
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(1, 2, 3, 16, 32, generator=g, device=dev)
    w = torch.randn(3, 3, 3, 32, 32, generator=g, device=dev) * (27 * 32)**-0.5
    b = torch.randn(32, generator=g, device=dev)
    name = "conv3d_int8" if mode == "kf_int8" else "conv3d"
    before = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    out = conv3d.conv3d_ndhwc(x, w, b, time_pad=2, mode=mode)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before[0][name] + 1
    assert _build.PLAIN_CALLS == before[1]
    assert out.dtype == torch.float32
    ref = conv3d.conv3d_ndhwc(x.cpu(), w.cpu(), b.cpu(), time_pad=2,
                              mode=mode)
    if mode == "kf_int8":
        assert torch.equal(out.cpu(), ref)
    else:
        _close_f32_conv(out.cpu(), ref)


def _close_f32_conv(got, want):
    # fp32 on both sides: the kernel sums the kt*9*C products in one
    # sequential chain of FMAs, the plain version tap by tap; outputs are
    # of order 1 here, so the orders differ by a few 1e-6
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("kt,time_pad,c,co", list(itertools.product(
    [1, 3], [0, 2], [8, 64], [3, 40, 72])))
def test_conv3d_fp32_matches_plain(dev, kt, time_pad, c, co):
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(2, 4, 5, 7, c, generator=g, device=dev)
    w = torch.randn(kt, 3, 3, c, co, generator=g, device=dev) * (
        kt * 9 * c)**-0.5
    b = torch.randn(co, generator=g, device=dev)
    out = conv3d.conv3d_ndhwc(x, w, b, time_pad=time_pad)
    ref = conv3d.conv3d_ndhwc_plain(x, w, b, time_pad=time_pad)
    assert out.shape == (2, 4 + time_pad - kt + 1, 5, 7, co)
    torch.cuda.synchronize()
    _close_f32_conv(out.cpu(), ref.cpu())


def test_conv3d_int8_fp32_store_matches_plain(dev):
    xq, wq, scale, bias = _int8_case(dev, 2, 3, 5, 13, 64, 96, 3)
    kw = dict(time_pad=2, out_dtype=torch.float32)
    out = conv3d.conv3d_int8(xq, wq, scale, bias, **kw)
    ref = conv3d.conv3d_int8_plain(xq, wq, scale, bias, **kw)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == torch.float32
    assert torch.equal(out, ref)


def _kv_mask(kind, skv, g, dev):
    pos = torch.arange(skv, device=dev)
    if kind == "empty_front":  # a stream's first blocks: the window's tail
        return pos >= skv - 200
    if kind == "sink_window":  # a frozen sink, then the filled window
        return (pos < 96) | (pos >= 700)
    return torch.rand(skv, generator=g, device=dev) < 0.3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["empty_front", "sink_window", "random"])
def test_flash_kv_mask_matches_plain(dev, kind, dtype):
    g = torch.Generator(device=dev).manual_seed(5)
    b, sq, skv, h, d = 1, 150, 1152, 2, 128
    q = torch.randn(b, sq, h, d, generator=g, device=dev, dtype=dtype)
    k = torch.randn(b, skv, h, d, generator=g, device=dev, dtype=dtype)
    v = torch.randn(b, skv, h, d, generator=g, device=dev, dtype=dtype)
    mask = _kv_mask(kind, skv, g, dev)
    out = flash_attention.flash_attention_kv_mask(q, k, v, mask,
                                                  scale=d**-0.5)
    ref = flash_attention.flash_attention_kv_mask_plain(q, k, v, mask,
                                                        scale=d**-0.5)
    _close(out, ref, dtype)
    # 0/1 integers name the same mask as booleans
    again = flash_attention.flash_attention_kv_mask(
        q, k, v, mask.to(torch.int32), scale=d**-0.5)
    assert torch.equal(again, out)


def test_flash_kv_mask_counts_its_own_launches(dev):
    q = torch.randn(1, 64, 1, 128, device=dev, dtype=torch.bfloat16)
    mask = torch.ones(64, dtype=torch.bool, device=dev)
    before = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    flash_attention.flash_attention_kv_mask(q, q, q, mask)
    torch.cuda.synchronize()
    after = dict(before[0], flash_fwd_kv_mask=before[0][
        "flash_fwd_kv_mask"] + 1)
    assert _build.LAUNCHES == after
    assert _build.PLAIN_CALLS == before[1]
    with pytest.raises(_build.KernelError, match="kv_mask"):
        flash_attention.flash_attention_kv_mask(q, q, q, mask[:10])


@pytest.mark.parametrize("mode,c,w,int8", [
    ("kf_int8", 32, 16, True), ("auto_int8", 64, 256, True),
    ("auto_int8", 64, 255, False), ("kf_int8", 48, 16, False),
])
def test_conv3d_ndhwc_int8_modes_route_as_jax(dev, mode, c, w, int8):
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(1, 2, 3, w, c, generator=g, device=dev,
                    dtype=torch.bfloat16)
    wt = (torch.randn(3, 3, 3, c, 32, generator=g, device=dev) *
          (27 * c)**-0.5).to(torch.bfloat16)
    b = torch.randn(32, generator=g, device=dev).to(torch.bfloat16)
    before = dict(_build.LAUNCHES)
    out = conv3d.conv3d_ndhwc(x, wt, b, time_pad=2, mode=mode)
    name = "conv3d_int8" if int8 else "conv3d"
    assert _build.LAUNCHES[name] == before[name] + 1
    ref = conv3d.conv3d_ndhwc(x.cpu(), wt.cpu(), b.cpu(), time_pad=2,
                              mode=mode)
    if int8:  # same quantized operands, exact sums
        _one_bf16_ulp(out.cpu(), ref)
    else:
        _close(out.cpu(), ref, torch.bfloat16, attention=False)


@pytest.mark.parametrize("weight_only", [False, True])
def test_int8_linear_matches_cpu(dev, weight_only):
    from fastvideo_tpu_torch.layers.linear import Linear
    from fastvideo_tpu_torch.layers.quantization.int8 import Int8Linear

    torch.manual_seed(0)
    lin = Linear(96, 40, dtype=torch.bfloat16)
    q = Int8Linear.from_linear(lin, weight_only=weight_only)
    x = torch.randn(2, 7, 96).to(torch.bfloat16)  # 14 rows: padded to 17
    want = q(x)
    got = q.to(dev)(x.to(dev))
    torch.cuda.synchronize()
    if weight_only:  # a bf16 F.linear: summation order only
        _close(got.cpu(), want, torch.bfloat16, attention=False)
    else:  # exact int32 sums, the same fp32 epilogue
        assert torch.equal(got.cpu(), want)


# -- backward kernels (K6, K7 bwd) and the grad rule --------------------------


def _close_grad(got, want):
    """A gradient against its plain version, both bf16 with the same
    rounding points: dS and p round to bf16 before the products, and one
    element of them may round the other way where the fp32 sums differ in
    order, so the attention rule (2^-6 relative plus 2^-5 of the plain
    gradient's std) holds it."""
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("b,sq,skv,h,d,causal,kv_valid", [
    (1, 300, 512, 2, 128, False, None),  # the cross-attention's form
    (2, 77, 130, 3, 64, True, 100),
    (1, 150, 70, 2, 16, False, 33),      # a head of 16 (the tiny models)
    (1, 64, 64, 1, 32, False, 0),        # every row empty
])
def test_flash_bwd_matches_plain(dev, b, sq, skv, h, d, causal, kv_valid):
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev,
                           dtype=torch.bfloat16) for s in (sq, skv, skv))
    # dO as autograd may hand it: a strided view
    do = torch.randn(b, sq, h, 2 * d, generator=g, device=dev,
                     dtype=torch.bfloat16)[..., ::2]
    kw = dict(scale=d**-0.5, causal=causal,
              kv_valid=skv if kv_valid is None else kv_valid)
    out, lse = flash_attention.flash_attention(q, k, v, return_lse=True,
                                               **kw)
    before = dict(_build.LAUNCHES)
    got = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert _build.LAUNCHES[name] == before[name] + 1
    want = flash_attention.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                     **kw)
    for t, w in zip(got, want):
        assert t.shape == w.shape and t.dtype == w.dtype
        if kv_valid == 0:
            torch.cuda.synchronize()
            assert torch.all(t == 0)
        else:
            _close_grad(t, w)


@pytest.mark.parametrize("e,nb,topk,d,full", [
    (280, 9, 4, 128, True),   # the 480p tile, not a multiple of 64
    (256, 7, 4, 128, False),  # the padded (4, 8, 8) tile
    (40, 6, 2, 32, False),    # a tile smaller than a block's 64 rows
    (64, 6, 3, 16, True),     # a head of 16 (the tiny models)
])
def test_vsa_sparse_bwd_matches_plain(dev, e, nb, topk, d, full):
    q, k, v, idx, sizes = _padded_case(dev, 2, 3, nb, e, d, topk, seed=8)
    # the padded slots hold zeros, as the backend leaves them
    pad = (torch.arange(nb * e, device=dev) % e) >= sizes.repeat_interleave(e)
    k[:, :, pad] = 0
    v[:, :, pad] = 0
    if full:
        sizes = torch.full_like(sizes, e)
    # a query tile whose every slot is a sentinel: its rows get zeros
    idx[0, 0, 1] = -1
    g = torch.Generator(device=dev).manual_seed(9)
    do = torch.randn(q.shape, generator=g, device=dev, dtype=torch.bfloat16)
    scale = d**-0.5
    out, lse = vsa.block_sparse_attention(q, k, v, idx, sizes, scale=scale,
                                          tile_elems=e, return_lse=True)
    before = dict(_build.LAUNCHES)
    got = vsa.block_sparse_attention_bwd(q, k, v, idx, sizes, out, lse, do,
                                         scale=scale, tile_elems=e)
    for name in ("vsa_sparse_bwd_dq", "vsa_sparse_bwd_dkv"):
        assert _build.LAUNCHES[name] == before[name] + 1
    want = vsa.block_sparse_attention_bwd_plain(
        q, k, v, idx, sizes, out, lse, do, scale=scale, tile_elems=e)
    torch.cuda.synchronize()
    assert torch.all(got[0][0, 0, e:2 * e] == 0)
    for t, w in zip(got, want):
        assert t.shape == w.shape and t.dtype == w.dtype
        _close_grad(t, w)


def _grad_case(dev, kind):
    """(wrapper call, its leaf tensors) on the card for the grad rule."""
    g = torch.Generator(device=dev).manual_seed(10)
    bf = torch.bfloat16

    def leaf(*shape, dtype=bf):
        return torch.randn(*shape, generator=g, device=dev,
                           dtype=dtype).requires_grad_()

    if kind == "flash":
        ts = [leaf(1, 90, 2, 64), leaf(1, 70, 2, 64), leaf(1, 70, 2, 64)]
        return lambda q, k, v: flash_attention.flash_attention(
            q, k, v, kv_valid=61), ts
    if kind in ("vsa_fast", "vsa_padded"):
        e, nb = (64, 6) if kind == "vsa_fast" else (40, 6)
        ts = [leaf(1, 2, nb * e, 32) for _ in range(3)]
        sizes = torch.full((nb,), e, dtype=torch.int32, device=dev)
        sizes[-1] = e - 9

        def call(q, k, v):
            return vsa.video_sparse_attn(q, k, v, sizes, 3, tile_elems=e,
                                         full_tiles=kind == "vsa_fast",
                                         q_group=2)
        return call, ts
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["flash", "vsa_fast", "vsa_padded"])
def test_grad_rule_backward_equals_plain(dev, kind):
    """A wrapper with a backward: its gradients on the card equal the plain
    version's on the CPU (same inputs), through the kernels only."""
    call, ts = _grad_case(dev, kind)
    before = dict(_build.PLAIN_CALLS)
    out = call(*ts)
    assert out.grad_fn is not None
    out.float().square().sum().backward()
    assert _build.PLAIN_CALLS == before
    cpu = [t.detach().cpu().requires_grad_() for t in ts]
    call(*cpu).float().square().sum().backward()
    for t, c in zip(ts, cpu):
        _close_grad(t.grad.cpu(), c.grad)


@pytest.mark.parametrize("kind", ["flash_fp32", "kv_mask", "k2", "k8",
                                  "sta", "sla", "conv3d", "conv3d_int8",
                                  "k9a", "k9b"])
def test_grad_rule_kernels_without_backward_raise(dev, kind):
    """A wrapper with no backward raises for operands that require grad,
    rather than return an output without a grad_fn; under no_grad it
    runs."""
    from fastvideo_tpu_torch.ops import sla, sta

    g = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16
    x = torch.randn(1, 128, 2, 64, generator=g, device=dev, dtype=bf)
    xt = x.transpose(1, 2)
    idx = torch.zeros(1, 2, 2, 1, device=dev, dtype=torch.int32)
    sizes = torch.full((2,), 64, device=dev, dtype=torch.int32)
    cx = torch.randn(1, 2, 4, 16, 32, generator=g, device=dev, dtype=bf)
    cw = torch.randn(3, 3, 3, 32, 32, generator=g, device=dev, dtype=bf)
    cb = torch.zeros(32, device=dev, dtype=bf)
    calls = {
        "flash_fp32": lambda t: flash_attention.flash_attention(
            t.float(), t.float(), t.float()),
        "kv_mask": lambda t: flash_attention.flash_attention_kv_mask(
            t, t, t, torch.ones(128, dtype=torch.bool, device=dev)),
        "k2": lambda t: vsa.block_sparse_attention_fast(
            t.transpose(1, 2), xt, xt, idx, tile_elems=64),
        "k8": lambda t: vsa.block_sparse_attention(
            t.transpose(1, 2), xt, xt, idx, sizes),
        "sta": lambda t: sta.sliding_tile_attention(
            t, x, x, (2, 8, 8), ((3, 3, 3), (3, 3, 3)), (2, 4, 4)),
        "sla": lambda t: sla.sla_attention(t, x, x, topk_ratio=0.5),
        "conv3d": lambda t: conv3d.conv3d_ndhwc(t, cw, cb, time_pad=2),
        "conv3d_int8": lambda t: conv3d.conv3d_ndhwc(t, cw, cb, time_pad=2,
                                                     mode="kf_int8"),
        "k9a": lambda t: nabla.nabla_attention(t, x, x),
        "k9b": lambda t: bsa.bsa_attention(t, x, x),
    }
    leaf = (cx if kind.startswith("conv3d") else x).clone().requires_grad_()
    with pytest.raises(_build.KernelError, match="backward"):
        calls[kind](leaf)
    with torch.no_grad():
        calls[kind](leaf)
    torch.cuda.synchronize()


def _dyn_mask(counts, nq, nk, h, g, dev):
    """A bool [1, h, nq, nk] mask: each row keeps ``counts`` random tiles
    ("one", "all"), or 0 (the first row), 1, ..., nk cycling ("mixed")."""
    mask = torch.zeros(1, h, nq, nk, dtype=torch.bool, device=dev)
    for hi in range(h):
        for qi in range(nq):
            n = {"one": 1, "all": nk}.get(counts, (qi + hi) % (nk + 1))
            keep = torch.randperm(nk, generator=g, device=dev)[:n]
            mask[0, hi, qi, keep] = True
    return mask


@pytest.mark.parametrize("counts", ["one", "all", "mixed"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("q_rows", [None, 8, 32, 64],
                         ids=["k9a", "k9b_8", "k9b_32", "k9b_64"])
def test_dyn_sparse_matches_plain(dev, q_rows, d, counts):
    """K9a (a query tile of 64 rows) and K9b (q_rows rows) against the
    plain version on the same indices and counts; a row of count 0 is
    exactly 0. bf16 attention tolerance (_close)."""
    g = torch.Generator(device=dev).manual_seed(d + (q_rows or 0))
    h, nk = 3, 7
    rows = q_rows or 64
    bf = torch.bfloat16
    q = torch.randn(2, h, nk * rows, d, generator=g, device=dev, dtype=bf)
    # k/v as strided views of a wider buffer
    kv = torch.randn(2, h, nk * 64, 2 * d, generator=g, device=dev, dtype=bf)
    k, v = kv[..., :d], kv[..., d:]
    mask = torch.cat([_dyn_mask(counts, nk, nk, h, g, dev)
                      for _ in range(2)])
    idx, cnt = nabla.mask_indices(mask)
    sizes = torch.full((nk,), 64, dtype=torch.int32, device=dev)
    kw = dict(scale=d**-0.5, q_rows=q_rows)
    out = nabla.dyn_sparse_attention(q, k, v, idx, cnt, sizes, **kw)
    ref = nabla.dyn_sparse_attention_plain(q, k, v, idx, cnt, sizes, **kw)
    _close(out, ref, bf)
    if counts == "mixed":
        empty = (cnt == 0).repeat_interleave(rows, dim=-1)
        assert empty.any() and (out[empty] == 0).all()


@pytest.mark.parametrize("kernel", ["dyn_sparse_fwd", "dyn_sparse_qtile_fwd"])
def test_dyn_sparse_counts_its_own_launches_and_refuses(dev, kernel):
    """Each entry adds one to its own counter and runs no plain version;
    an fp32 operand, a head dim above 128 and operands that require grad
    raise before any launch."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(1, 2, 256, 64, generator=g, device=dev,
                    dtype=torch.bfloat16)
    mask = torch.ones(1, 2, 4, 4, dtype=torch.bool, device=dev)
    sizes = torch.full((4,), 64, dtype=torch.int32, device=dev)

    def call(q, k, v):
        if kernel == "dyn_sparse_fwd":
            return nabla.masked_block_sparse_attention(q, k, v, mask, sizes)
        return bsa._masked_sparse_qtile(q[:, :, :128], k, v, mask, sizes, 32,
                                        scale=0.125)

    before = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    call(x, x, x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict(before[0],
                                   **{kernel: before[0][kernel] + 1})
    assert _build.PLAIN_CALLS == before[1]
    wide = torch.randn(1, 2, 256, 256, generator=g, device=dev,
                       dtype=torch.bfloat16)
    for bad, match in ((x.float(), "bfloat16"), (wide, "bfloat16"),
                       (x.clone().requires_grad_(), "backward")):
        with pytest.raises(_build.KernelError, match=match):
            call(bad, bad.detach(), bad.detach())
    assert _build.LAUNCHES[kernel] == before[0][kernel] + 1


@pytest.mark.parametrize("sq,ct,clean_len,kv_valid,d,dtype", [
    # chunk borders inside 64-row tiles (40 and 56 are no multiple of 64)
    (200, 40, 0, None, 64, torch.bfloat16),
    (230, 56, 0, 170, 128, torch.bfloat16),
    # teacher forcing: the clean/noisy border at 150 cuts a tile
    (300, 48, 150, None, 128, torch.bfloat16),
    (192, 32, 96, 180, 64, torch.bfloat16),
    # a head of 16 (the tiny models), chunks of one 16-token frame
    (130, 16, 65, None, 16, torch.bfloat16),
    (200, 40, 100, None, 64, torch.float32),  # fp32 forward only
])
def test_flash_struct_matches_plain(dev, sq, ct, clean_len, kv_valid, d,
                                    dtype):
    """K1 struct (out and LSE) and, in bf16, K6 struct (dq, dk, dv) against
    their plain versions; each counted on its own counter, K1's and K6's
    untouched."""
    g = torch.Generator(device=dev).manual_seed(11)
    b, h = 2, 3
    q, k, v = (torch.randn(b, sq, h, d, generator=g, device=dev, dtype=dtype)
               for _ in range(3))
    do = torch.randn(b, sq, h, 2 * d, generator=g, device=dev,
                     dtype=dtype)[..., ::2]
    kw = dict(scale=d**-0.5, kv_valid=sq if kv_valid is None else kv_valid,
              chunk_tokens=ct, tf_clean_len=clean_len)
    before = dict(_build.LAUNCHES)
    out, lse = flash_attention.flash_attention(q, k, v, return_lse=True,
                                               **kw)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, **kw)
    _close(out, ref, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    expect = {"flash_fwd_struct": 1}
    if dtype == torch.bfloat16:
        got = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        want = flash_attention.flash_attention_bwd_plain(q, k, v, out, lse,
                                                         do, **kw)
        for t, w in zip(got, want):
            assert t.shape == w.shape and t.dtype == w.dtype
            _close_grad(t, w)
        expect.update(flash_bwd_struct_dq=1, flash_bwd_struct_dkv=1)
        # a split dK/dV grid adds its partial sums on its own counter
        if flash_attention.dkv_splits(b, h, sq, sq, d,
                                      _build.num_sms(dev)) > 1:
            expect.update(flash_bwd_dkv_reduce=1)
    assert {n: _build.LAUNCHES[n] - before[n] for n in before
            if _build.LAUNCHES[n] != before[n]} == expect


def test_flash_struct_under_autograd_takes_the_struct_backward(dev):
    """flash_attention with chunk_tokens under grad runs K1 struct forward
    and K6 struct backward, and its gradients equal the plain backward's
    on the forward's own out and LSE."""
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v = (torch.randn(1, 256, 2, 128, generator=g, device=dev,
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    kw = dict(chunk_tokens=48, tf_clean_len=128)
    before = dict(_build.LAUNCHES)
    out, lse = flash_attention.flash_attention(q, k, v, return_lse=True, **kw)
    do = torch.randn(out.shape, generator=g, device=dev, dtype=out.dtype)
    out.backward(do)
    for name in ("flash_fwd_struct", "flash_bwd_struct_dq",
                 "flash_bwd_struct_dkv"):
        assert _build.LAUNCHES[name] == before[name] + 1
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _build.LAUNCHES[name] == before[name]
    want = flash_attention.flash_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), out.detach(), lse, do,
        scale=128**-0.5, **kw)
    for t, w in zip((q.grad, k.grad, v.grad), want):
        _close_grad(t, w)


# -- the flash kernels' Hopper schedule (bf16, heads of 64 and 128) -----------


def _strided(t, dev):
    """The same values as a [B, S, H, D] view with padded rows and heads."""
    b, s, h, d = t.shape
    wide = torch.zeros(b, s, h + 1, d + 64, device=dev, dtype=t.dtype)
    wide[:, :, :h, 32:32 + d] = t
    return wide[:, :, :h, 32:32 + d]


@pytest.mark.parametrize("b,sq,skv,h,d,causal,kv_valid,strided", [
    # neither length a multiple of 128: a ragged last query tile and key
    # chunk (the ring's last stage half full)
    (1, 300, 333, 2, 128, False, None, False),
    (2, 130, 700, 3, 64, True, 650, True),
    (1, 129, 257, 2, 128, True, None, True),
    (1, 600, 512, 2, 128, False, None, False),  # the cross-attention's keys
    (1, 64, 96, 2, 128, False, 0, False),        # every row empty
    (1, 200, 150, 1, 64, False, 0, True),
])
def test_flash_sm90_matches_plain(dev, b, sq, skv, h, d, causal, kv_valid,
                                  strided):
    """K1 and K6 on the Hopper schedule against their plain versions: out,
    LSE (-inf on empty rows), and dq, dk, dv from a strided dO, with the
    library taking that schedule for the shape."""
    g = torch.Generator(device=dev).manual_seed(21)
    assert _build.query("flash_fwd", "fvt_flash_fwd_sm90", 1, d) == 1
    assert _build.query("flash_bwd", "fvt_flash_bwd_sm90", d) == 1
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev,
                           dtype=torch.bfloat16) for s in (sq, skv, skv))
    if strided:
        q, k, v = (_strided(t, dev) for t in (q, k, v))
    do = torch.randn(b, sq, h, 2 * d, generator=g, device=dev,
                     dtype=torch.bfloat16)[..., ::2]
    kw = dict(scale=d**-0.5, causal=causal,
              kv_valid=skv if kv_valid is None else kv_valid)
    out, lse = flash_attention.flash_attention(q, k, v, return_lse=True,
                                               **kw)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, **kw)
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    got = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = flash_attention.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                     **kw)
    if kv_valid == 0:
        torch.cuda.synchronize()
        assert torch.all(out == 0) and not finite.any()
        for t in got:
            assert torch.all(t == 0)
        return
    _close(out, ref, torch.bfloat16)
    torch.testing.assert_close(lse[finite], ref_lse[finite], atol=1e-3,
                               rtol=1e-4)
    for t, w in zip(got, want):
        assert t.shape == w.shape and t.dtype == w.dtype
        _close_grad(t, w)


@pytest.mark.parametrize("sq,ct,clean_len,kv_valid,d", [
    # chunk borders inside 128-row tiles, and chunks longer than a tile:
    # full, partial and empty key chunks in one query tile
    (700, 100, 0, None, 128),
    (650, 300, 0, 600, 64),
    # teacher forcing: the clean/noisy border at 330 cuts a 128-row tile
    (660, 100, 330, None, 128),
    (520, 260, 260, 500, 64),
])
def test_flash_struct_sm90_matches_plain(dev, sq, ct, clean_len, kv_valid,
                                         d):
    """K1 struct and K6 struct on the Hopper schedule against their plain
    versions, where borders fall inside the 128-row tiles."""
    g = torch.Generator(device=dev).manual_seed(22)
    b, h = 1, 2
    q, k, v = (torch.randn(b, sq, h, d, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    do = torch.randn(b, sq, h, d, generator=g, device=dev,
                     dtype=torch.bfloat16)
    kw = dict(scale=d**-0.5, kv_valid=sq if kv_valid is None else kv_valid,
              chunk_tokens=ct, tf_clean_len=clean_len)
    out, lse = flash_attention.flash_attention(q, k, v, return_lse=True,
                                               **kw)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, **kw)
    _close(out, ref, torch.bfloat16)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    got = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = flash_attention.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                     **kw)
    for t, w in zip(got, want):
        _close_grad(t, w)


@pytest.mark.parametrize("kind", ["zero_chunks", "all_zero", "full"])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kv_mask_sm90_chunks(dev, kind, d):
    """K5 on the Hopper schedule with whole 128-key chunks masked (skipped),
    every key masked (output 0) and none masked."""
    g = torch.Generator(device=dev).manual_seed(23)
    b, sq, skv, h = 1, 200, 1300, 2
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev,
                           dtype=torch.bfloat16) for s in (sq, skv, skv))
    pos = torch.arange(skv, device=dev)
    mask = {"zero_chunks": ((pos // 128) % 3 == 1) | (pos >= 1250),
            "all_zero": pos < 0, "full": pos >= 0}[kind]
    out = flash_attention.flash_attention_kv_mask(q, k, v, mask,
                                                  scale=d**-0.5)
    ref = flash_attention.flash_attention_kv_mask_plain(q, k, v, mask,
                                                        scale=d**-0.5)
    if kind == "all_zero":
        torch.cuda.synchronize()
        assert torch.all(out == 0)
    else:
        _close(out, ref, torch.bfloat16)


def test_flash_bwd_split_dkv_and_reduce(dev):
    """At the cross-attention's 512 keys the dK/dV grid is split over the
    query rows (dkv_splits > 1 on this card): one dK/dV and one reduce
    launch, gradients equal to the plain backward's; the reduce kernel adds
    random partial sums as its plain version does."""
    g = torch.Generator(device=dev).manual_seed(24)
    b, sq, skv, h, d = 1, 2000, 512, 4, 128
    splits = flash_attention.dkv_splits(b, h, sq, skv, d,
                                        _build.num_sms(dev))
    assert splits > 1
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev,
                               dtype=torch.bfloat16)
                   for s in (sq, skv, skv, sq))
    kw = dict(scale=d**-0.5, causal=False, kv_valid=skv)
    out, lse = flash_attention.flash_attention(q, k, v, return_lse=True,
                                               **kw)
    before = dict(_build.LAUNCHES)
    got = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert {n: _build.LAUNCHES[n] - before[n] for n in before
            if _build.LAUNCHES[n] != before[n]} == {
                "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                "flash_bwd_dkv_reduce": 1}
    want = flash_attention.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                     **kw)
    for t, w in zip(got, want):
        _close_grad(t, w)
    shape = flash_attention.dkv_scratch_shape(3, 2, h, 300, d)
    part_k, part_v = (torch.randn(shape, generator=g, device=dev)
                      for _ in range(2))
    dk, dv = (torch.empty(2, 300, h, d, device=dev, dtype=torch.bfloat16)
              for _ in range(2))
    flash_attention.dkv_reduce(part_k, part_v, dk, dv)
    for t, w in zip((dk, dv), flash_attention.dkv_reduce_plain(part_k,
                                                               part_v)):
        torch.testing.assert_close(t.float(), w.float(), atol=0,
                                   rtol=2.0**-7)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 16),
                                     (torch.bfloat16, 384),
                                     (torch.float32, 128),
                                     (torch.float32, 384)])
def test_flash_library_schedule_is_the_host_rule(dev, dtype, d):
    fwd = _build.query("flash_fwd", "fvt_flash_fwd_sm90",
                       int(dtype == torch.bfloat16), d)
    assert ("tile", "sm90", "sm90_wide", "sm90_wide_tf32")[fwd] == \
        flash_attention.flash_schedule(dtype, d)
    if dtype == torch.bfloat16 and d <= 128:
        bwd = _build.query("flash_bwd", "fvt_flash_bwd_sm90", d)
        assert bool(bwd) == bool(fwd)
        assert ("sm90" if bwd else "tile") == \
            flash_attention.flash_bwd_schedule(d)


# -- the sparse kernels' Hopper schedule (K7 bwd, K9a, K9b) -------------------


def _sparse_bwd_case(dev, e, nb, topk, d, seed):
    """K7 bwd inputs with ragged valid counts (tile 1 keeps no key), -1
    slots inside the top-k, a query tile whose every kept tile is empty
    (its rows get a gradient of exactly 0) and padded slots of zeros, as
    the tiling leaves them."""
    q, k, v, idx, sizes = _padded_case(dev, 1, 2, nb, e, d, topk, seed=seed)
    sizes[1] = 0
    sizes[2] = e - 24
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    k, v = (torch.randn(q.shape, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    pad = (torch.arange(nb * e, device=dev) % e) >= sizes.repeat_interleave(e)
    k[:, :, pad] = 0
    v[:, :, pad] = 0
    idx[0, 0, 3] = -1
    idx[0, 0, 3, 0] = 1  # only the empty tile
    idx[0, 1, 4, 0] = -1  # a -1 slot before kept ones
    do = torch.randn(q.shape, generator=g, device=dev, dtype=torch.bfloat16)
    return q, k, v, do, idx, sizes


@pytest.mark.parametrize("e,nb,topk,d", [
    (280, 9, 4, 128),   # the 480p tile: four 64-row units and one of 24
    (256, 7, 4, 128),   # the padded (4, 8, 8) tile
    (280, 6, 3, 64),    # a head of 64
    (100, 5, 5, 64),    # every tile in each top-k
])
def test_vsa_sparse_bwd_sm90_matches_plain(dev, e, nb, topk, d):
    """K7 bwd on the Hopper schedule against its plain version: ragged
    units, valid counts below E and of 0, -1 slots, a row whose kept tiles
    are all empty (exactly 0), with the library taking that schedule."""
    assert _build.query("vsa_sparse_bwd", "fvt_vsa_sparse_bwd_sm90", d) == 1
    q, k, v, do, idx, sizes = _sparse_bwd_case(dev, e, nb, topk, d, seed=30)
    kw = dict(scale=d**-0.5, tile_elems=e)
    out, lse = vsa.block_sparse_attention(q, k, v, idx, sizes,
                                          return_lse=True, **kw)
    got = vsa.block_sparse_attention_bwd(q, k, v, idx, sizes, out, lse, do,
                                         **kw)
    want = vsa.block_sparse_attention_bwd_plain(q, k, v, idx, sizes, out,
                                                lse, do, **kw)
    torch.cuda.synchronize()
    assert torch.all(got[0][0, 0, 3 * e:4 * e] == 0)
    for t in got[1:]:  # keys of the tile with no valid key
        assert torch.all(t[:, :, e:2 * e] == 0)
    for t, w in zip(got, want):
        assert t.shape == w.shape and t.dtype == w.dtype
        _close_grad(t, w)


def test_vsa_sparse_bwd_first_schedule_at_other_heads(dev):
    """A head of 48 runs the first schedule (its dK/dV over the same
    transposed lists) and matches its plain version; fp32 operands
    raise."""
    d = 48
    assert _build.query("vsa_sparse_bwd", "fvt_vsa_sparse_bwd_sm90", d) == 0
    assert ss.sparse_schedule(torch.bfloat16, d) == "tile"
    q, k, v, do, idx, sizes = _sparse_bwd_case(dev, 70, 5, 3, d, seed=31)
    kw = dict(scale=d**-0.5, tile_elems=70)
    out, lse = vsa.block_sparse_attention(q, k, v, idx, sizes,
                                          return_lse=True, **kw)
    got = vsa.block_sparse_attention_bwd(q, k, v, idx, sizes, out, lse, do,
                                         **kw)
    want = vsa.block_sparse_attention_bwd_plain(q, k, v, idx, sizes, out,
                                                lse, do, **kw)
    for t, w in zip(got, want):
        _close_grad(t, w)
    with pytest.raises(_build.KernelError, match="bfloat16"):
        vsa.block_sparse_attention_bwd(q.float(), k.float(), v.float(), idx,
                                       sizes, out.float(), lse, do.float(),
                                       **kw)


@pytest.mark.parametrize("q_rows,e,d", [
    (None, 96, 128),  # K9a with 96-row tiles: a unit of 32, one tile a block
    (24, 96, 64),     # K9b, 5 query tiles of 24 rows a block
    (40, 64, 128),    # K9b, 3 of 40 rows a block (120 rows)
    (8, 64, 64),      # K9b, 16 tiles of 8 rows a block
])
def test_dyn_sparse_sm90_groups_and_ragged_units(dev, q_rows, e, d):
    """K9 on the Hopper schedule where a group's tiles split a warpgroup,
    key tiles end in a ragged unit with valid counts below E, and the
    number of query tiles is not a multiple of the group: against the plain
    version, counts of 0 exactly 0."""
    assert _build.query("dyn_sparse_fwd", "fvt_dyn_sparse_fwd_sm90_route",
                        d) == 1
    g = torch.Generator(device=dev).manual_seed(32)
    h, nk = 2, 7
    rows = q_rows or e
    nq = 2 * ss.query_group(rows) + 1
    bf = torch.bfloat16
    q = torch.randn(1, h, nq * rows, d, generator=g, device=dev, dtype=bf)
    k, v = (torch.randn(1, h, nk * e, d, generator=g, device=dev, dtype=bf)
            for _ in range(2))
    sizes = torch.full((nk,), e, dtype=torch.int32, device=dev)
    sizes[1], sizes[3] = e - 40, 0
    pad = (torch.arange(nk * e, device=dev) % e) >= sizes.repeat_interleave(e)
    k[:, :, pad] = 0
    v[:, :, pad] = 0
    mask = _dyn_mask("mixed", nq, nk, h, g, dev)
    idx, cnt = nabla.mask_indices(mask)
    kw = dict(scale=d**-0.5, tile_elems=e, q_rows=q_rows)
    out = nabla.dyn_sparse_attention(q, k, v, idx, cnt, sizes, **kw)
    ref = nabla.dyn_sparse_attention_plain(q, k, v, idx, cnt, sizes, **kw)
    _close(out, ref, bf)
    empty = (cnt == 0).repeat_interleave(rows, dim=-1)
    assert empty.any() and (out[empty] == 0).all()


def test_dyn_sparse_first_schedule_at_other_heads(dev):
    """A head of 48 runs K9's first schedule and matches its plain version
    (K9a and K9b); fp32 operands raise."""
    assert _build.query("dyn_sparse_fwd", "fvt_dyn_sparse_fwd_sm90_route",
                        48) == 0
    g = torch.Generator(device=dev).manual_seed(33)
    h, nk, d, bf = 2, 5, 48, torch.bfloat16
    k, v = (torch.randn(1, h, nk * 64, d, generator=g, device=dev, dtype=bf)
            for _ in range(2))
    mask = _dyn_mask("mixed", nk, nk, h, g, dev)
    idx, cnt = nabla.mask_indices(mask)
    sizes = torch.full((nk,), 64, dtype=torch.int32, device=dev)
    for q_rows in (None, 32):
        q = torch.randn(1, h, nk * (q_rows or 64), d, generator=g, device=dev,
                        dtype=bf)
        kw = dict(scale=d**-0.5, q_rows=q_rows)
        _close(nabla.dyn_sparse_attention(q, k, v, idx, cnt, sizes, **kw),
               nabla.dyn_sparse_attention_plain(q, k, v, idx, cnt, sizes,
                                                **kw), bf)
        with pytest.raises(_build.KernelError, match="bfloat16"):
            nabla.dyn_sparse_attention(q.float(), k.float(), v.float(), idx,
                                       cnt, sizes, **kw)


def test_sparse_sm90_unaligned_view_raises(dev):
    """A base the tensor maps cannot take (not 16-byte aligned) makes the
    Hopper entries fail and the wrapper's launch raise: no other schedule
    runs in its place."""
    g = torch.Generator(device=dev).manual_seed(34)
    h, nk, d, e = 2, 4, 64, 64
    buf = torch.randn(1, h, nk * e * d + 8, generator=g, device=dev,
                      dtype=torch.bfloat16)
    bad = buf[..., 1:1 + nk * e * d].reshape(1, h, nk * e, d)  # 2-byte offset
    x = torch.randn(1, h, nk * e, d, generator=g, device=dev,
                    dtype=torch.bfloat16)
    mask = torch.ones(1, h, nk, nk, dtype=torch.bool, device=dev)
    lists, lens, bits, group = ss.grouped_lists(*nabla.mask_indices(mask),
                                                nk, e)
    order = ss.heaviest_first(lens)
    sizes = torch.full((nk,), e, dtype=torch.int32, device=dev)
    out = torch.empty_like(x)
    st = []
    for t in (bad, x, x, out):
        st += [t.stride(0), t.stride(1), t.stride(2)]
    before = dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelError, match="CUDA error"):
        _build.launch("dyn_sparse_fwd", "fvt_dyn_sparse_fwd_sm90",
                      bad.data_ptr(), x.data_ptr(), x.data_ptr(),
                      out.data_ptr(), lists.data_ptr(), lens.data_ptr(),
                      bits.data_ptr(), order.data_ptr(), sizes.data_ptr(), 1,
                      h, nk * e, nk * e, d, e, group, *st, 0.125,
                      _build.stream_ptr(x))
    lse = torch.zeros(1, h, nk * e, device=dev)
    idx = torch.zeros(1, h, nk, 1, dtype=torch.int32, device=dev)
    with pytest.raises(_build.KernelError, match="CUDA error"):
        _build.launch("vsa_sparse_bwd_dq", "fvt_vsa_sparse_bwd_dq",
                      bad.data_ptr(), x.data_ptr(), x.data_ptr(),
                      x.data_ptr(), lse.data_ptr(), lse.data_ptr(),
                      out.data_ptr(), idx.data_ptr(), sizes.data_ptr(), 1, h,
                      nk * e, d, e, 1, *st[:3], *st[3:6], *st[6:9], *st[3:6],
                      *st[9:], 0.125, _build.stream_ptr(x))
    assert _build.LAUNCHES == before


# -- the padded forward's (K8 / K7 fwd) and the conv's (K3) Hopper schedules --


@pytest.mark.parametrize("e,nb,topk,d", [
    (280, 6, 4, 128),  # 4i's exact tile: its third block holds 24 rows
    (256, 5, 3, 64),   # the padded (4, 8, 8) tile, a head of 64
    (64, 11, 4, 128),  # SLA's tile: one warpgroup a 64-row block
    (32, 9, 3, 64),    # two 32-row tiles walk one 64-row block's union
])
def test_vsa_sparse_padded_sm90_matches_plain(dev, e, nb, topk, d):
    """K8 / K7 fwd on the Hopper schedule against the plain version: out
    and LSE, ragged valid counts with non-finite padded key slots, -1
    slots, and a query tile with no key (exactly 0, LSE MASK_VALUE); the
    library takes that schedule and the launch is counted."""
    assert _build.query("vsa_sparse_padded_fwd",
                        "fvt_vsa_sparse_padded_fwd_route", d) == 1
    assert ss.sparse_schedule(torch.bfloat16, d) == "sm90"
    q, k, v, idx, sizes = _padded_case(dev, 1, 2, nb, e, d, topk, seed=40)
    idx[0, 1, 2] = -1
    before = _build.LAUNCHES["vsa_sparse_padded_fwd"]
    plain = dict(_build.PLAIN_CALLS)
    out, lse = vsa.block_sparse_attention(q, k, v, idx, sizes, tile_elems=e,
                                          return_lse=True)
    assert _build.LAUNCHES["vsa_sparse_padded_fwd"] == before + 1
    assert _build.PLAIN_CALLS == plain
    ref, ref_lse = _plain_padded(q, k, v, idx, sizes, e, return_lse=True)
    torch.cuda.synchronize()
    assert (out[0, 1, 2 * e:3 * e] == 0).all()
    assert (lse[0, 1, 2 * e:3 * e] == vsa.MASK_VALUE).all()
    _close(out, ref, torch.bfloat16)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    assert torch.equal(vsa.block_sparse_attention(q, k, v, idx, sizes,
                                                  tile_elems=e), out)


@pytest.mark.parametrize("c,co,kt,time_pad,t,h,w", [
    (96, 96, 3, 0, 4, 6, 70),     # up3's conv: a W tail (16 x 8 patches)
    (96, 96, 3, 2, 1, 2, 64),     # the first chunk: 2 pad taps skipped
    (16, 384, 3, 2, 2, 5, 20),    # conv_in: channels padded to 32
    (96, 3, 3, 0, 3, 9, 24),      # conv_out: an N tile of 8, odd Co
    (192, 384, 3, 0, 3, 4, 16),   # three N tiles of 128
    (384, 192, 1, 0, 2, 8, 24),   # a resample: kt 1, two N tiles of 96
    (192, 192, 3, 1, 2, 1, 128),  # 128 x 1 patches, one pad frame
    (32, 40, 3, 0, 3, 60, 104),   # 8 x 16 patches, a Co tail
])
def test_conv3d_sm90_matches_plain(dev, c, co, kt, time_pad, t, h, w):
    """K3's Hopper schedule against the plain conv at the decoder's edges:
    each N tile width, each patch shape, W, H and Co tails, padded
    channels, the causal pad; the library's route and N tile are the host
    rule's."""
    assert _build.query("conv3d", "fvt_conv3d_route", 1, c, co) == 1
    assert conv3d.conv_schedule(torch.bfloat16, c, co) == "sm90"
    assert _build.query("conv3d", "fvt_conv3d_tile_n", co) == \
        conv3d.conv_tile_n(co)
    g = torch.Generator(device=dev).manual_seed(41)
    x = torch.randn(1, t, h, w, c, generator=g, device=dev,
                    dtype=torch.bfloat16)
    wt = (torch.randn(kt, 3, 3, c, co, generator=g, device=dev) *
          (kt * 9 * c)**-0.5).to(torch.bfloat16)
    b = torch.randn(co, generator=g, device=dev).to(torch.bfloat16)
    before = _build.LAUNCHES["conv3d"]
    out = conv3d.conv3d_ndhwc(x, wt, b, time_pad=time_pad)
    assert _build.LAUNCHES["conv3d"] == before + 1
    ref = conv3d.conv3d_ndhwc_plain(x, wt, b, time_pad=time_pad)
    assert out.shape == ref.shape
    _close(out, ref, torch.bfloat16, attention=False)


def test_conv3d_fp32_keeps_the_simt_schedule(dev):
    """fp32 takes its own schedule, the 3xTF32 one since it replaced the
    SIMT kernel, by the library's rule and the host's alike."""
    assert _build.query("conv3d", "fvt_conv3d_route", 0, 96, 96) == 2
    assert conv3d.conv_schedule(torch.float32, 96, 96) == "tf32x3"


# -- the VSA forward's (K2) and the int8 conv's (K4) Hopper schedules --------


@pytest.mark.parametrize("e,nb,qg,topk,d,walk", [
    (280, 9, 3, 4, 128, None),    # the main path's tile: 840-row groups, a
                                  # 72-row last block, the key stream
    (280, 9, 3, 4, 128, "tiles"),  # the same walked per tile
    (280, 6, 1, 2, 64, None),     # a 24-row last block: one live warpgroup
    (256, 6, 1, 3, 64, None),     # E 256: whole 64-row units only
    (256, 9, 3, 5, 128, "tiles"),
    (96, 8, 2, 3, 128, None),     # 64-key units across every tile's end
    (100, 6, 2, 3, 128, None),    # E % 8 != 0: the rule walks per tile
])
def test_vsa_sparse_sm90_matches_plain(dev, e, nb, qg, topk, d, walk):
    """K2 on the Hopper schedule against the plain version: each key walk,
    ragged last blocks and units, heads of 64 and 128; the library takes
    that schedule and the host's key-walk rule, and the launch is
    counted."""
    assert _build.query("vsa_sparse_fwd", "fvt_vsa_sparse_fwd_route", d) == 1
    assert ss.sparse_schedule(torch.bfloat16, d) == "sm90"
    assert ss.FAST_WALKS[_build.query("vsa_sparse_fwd",
                                      "fvt_vsa_sparse_fwd_walk", e)] == \
        ss.fast_key_walk(e)
    g = torch.Generator(device=dev).manual_seed(50)
    b, h = 2, 3
    q, k, v = (torch.randn(b, h, nb * e, d, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    ng = nb // qg
    idx = torch.stack([torch.randperm(nb, generator=g, device=dev)[:topk]
                       for _ in range(b * h * ng)]).reshape(b, h, ng, topk)
    before = _build.LAUNCHES["vsa_sparse_fwd"]
    plain = dict(_build.PLAIN_CALLS)
    if walk is None:
        out = vsa.block_sparse_attention_fast(q, k, v, idx, tile_elems=e)
    else:
        out = vsa._block_sparse_attention_cuda(q, k, v, idx, d**-0.5, e,
                                               walk=walk)
    assert _build.LAUNCHES["vsa_sparse_fwd"] == before + 1
    assert _build.PLAIN_CALLS == plain
    ref = vsa.block_sparse_attention_plain(q, k, v, idx, scale=d**-0.5,
                                           tile_elems=e)
    _close(out, ref, torch.bfloat16)


def test_vsa_sparse_first_schedule_at_other_heads(dev):
    """A head of 32 keeps K2's first schedule, whose entry refuses the
    Hopper heads; the Hopper entry refuses it and a stream walk of tiles
    that are not a multiple of 8 rows."""
    assert _build.query("vsa_sparse_fwd", "fvt_vsa_sparse_fwd_route", 32) == 0
    assert ss.sparse_schedule(torch.bfloat16, 32) == "tile"
    g = torch.Generator(device=dev).manual_seed(51)
    q, k, v = (torch.randn(1, 2, 6 * 96, 32, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    idx = torch.randint(0, 6, (1, 2, 3, 2), generator=g, device=dev,
                        dtype=torch.int32)
    out = vsa.block_sparse_attention_fast(q, k, v, idx, tile_elems=96)
    _close(out, vsa.block_sparse_attention_plain(
        q, k, v, idx, scale=32**-0.5, tile_elems=96), torch.bfloat16)
    q128 = torch.zeros(1, 1, 2 * 100, 128, device=dev, dtype=torch.bfloat16)
    idx1 = torch.zeros(1, 1, 1, 1, device=dev, dtype=torch.int32)
    with pytest.raises(_build.KernelError, match="launch failed"):
        vsa._block_sparse_attention_cuda(q128, q128, q128, idx1, 1.0, 100,
                                         walk="stream")
    with pytest.raises(_build.KernelError, match="launch failed"):
        _build.launch("vsa_sparse_fwd", "fvt_vsa_sparse_fwd", q128.data_ptr(),
                      q128.data_ptr(), q128.data_ptr(), q128.data_ptr(),
                      idx1.data_ptr(), 1, 1, 200, 128, 100, 1, 1,
                      *([0] * 12), 1.0, _build.stream_ptr(q128))


@pytest.mark.parametrize("c,co,kt,time_pad,t,h,w,out", [
    (96, 96, 3, 0, 4, 6, 70, torch.bfloat16),    # up3's conv, a W tail
    (96, 96, 3, 2, 1, 2, 64, torch.bfloat16),    # the first chunk: 2 pad taps
    (96, 96, 3, 1, 2, 5, 24, torch.float32),     # one pad frame, fp32 store
    (192, 192, 3, 0, 3, 4, 16, torch.bfloat16),  # an N tile of 192
    (192, 384, 3, 2, 2, 3, 20, torch.float32),   # two N tiles of 192
    (384, 384, 1, 0, 2, 8, 24, torch.bfloat16),  # kt 1, two N tiles
    (64, 96, 1, 2, 2, 1, 128, torch.float32),    # kt 1 behind pad frames,
                                                 # 128 x 1 patches
    (32, 32, 3, 2, 3, 60, 104, torch.bfloat16),  # the smallest route: an
                                                 # N tile of 96 for 32
])
def test_conv3d_int8_sm90_bit_for_bit(dev, c, co, kt, time_pad, t, h, w,
                                      out):
    """K4's Hopper schedule equals the plain version bit for bit (exact
    int32 sums, the same epilogue roundings) at each N tile, both stores,
    kt 1 and 3, 0 to 2 pad frames, W and H tails; the library's N tile is
    the host rule's and the launch is counted."""
    assert _build.query("conv3d_int8", "fvt_conv3d_int8_tile_n", co) == \
        conv3d.conv_int8_tile_n(co)
    xq, wq, scale, bias = _int8_case(dev, 1, t, h, w, c, co, kt, seed=52)
    kw = dict(time_pad=time_pad, out_dtype=out)
    before = _build.LAUNCHES["conv3d_int8"]
    got = conv3d.conv3d_int8(xq, wq, scale, bias, **kw)
    assert _build.LAUNCHES["conv3d_int8"] == before + 1
    want = conv3d.conv3d_int8_plain(xq, wq, scale, bias, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == out and got.shape == want.shape
    assert torch.equal(got, want)


def test_conv3d_int8_sm90_non_contiguous_input(dev):
    xq, wq, scale, bias = _int8_case(dev, 2, 3, 5, 13, 96, 192, 3, seed=53)
    wide = torch.cat([xq, xq], dim=-1)[..., 96:]  # strided channels
    assert not wide.is_contiguous()
    kw = dict(time_pad=2, out_dtype=torch.bfloat16)
    got = conv3d.conv3d_int8(wide, wq, scale, bias, **kw)
    want = conv3d.conv3d_int8_plain(xq, wq, scale, bias, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)



# -- K1 at a head of 384 (the VAE attention) and K3's fp32 form -------------


@pytest.mark.parametrize("b,sq,skv,h,causal,kv_valid,qkv", [
    (1, 6240, 6240, 1, False, None, True),   # the first decode chunk
    (2, 1000, 1000, 1, False, None, True),   # a ragged tile, 2 frames
    (2, 77, 130, 3, False, 60, False),       # kv_valid inside a chunk
    (1, 300, 333, 2, True, None, False),     # causal, ragged chunks
    (1, 4000, 130, 8, False, None, False),   # one split: O written direct
    (1, 64, 96, 2, False, 0, False),         # every row empty
])
def test_flash_wide_matches_plain(dev, b, sq, skv, h, causal, kv_valid,
                                  qkv):
    """K1 on the wide schedule (bf16, head 384) against the plain version:
    out within the attention tolerance, the LSE within 1e-3 (-inf on empty
    rows), from q/k/v column views of one qkv tensor as the VAE passes
    them; the library's split rule is the host's, and a split launch also
    counts its combine."""
    d = 384
    g = torch.Generator(device=dev).manual_seed(61)
    if qkv:
        t = torch.randn(b, sq, h, 3 * d, generator=g, device=dev,
                        dtype=torch.bfloat16)
        q, k, v = t[..., :d], t[..., d:2 * d], t[..., 2 * d:]
    else:
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev,
                               dtype=torch.bfloat16) for s in (sq, skv, skv))
    kw = dict(scale=d**-0.5, causal=causal,
              kv_valid=skv if kv_valid is None else kv_valid)
    splits = flash_attention.wide_splits(
        b, h, sq, min(kw["kv_valid"], skv), _build.num_sms(dev))
    assert _build.query("flash_fwd", "fvt_flash_fwd_wide_splits", b, h, sq,
                        skv, kw["kv_valid"], _build.num_sms(dev)) == splits
    before = dict(_build.LAUNCHES)
    out, lse = flash_attention.flash_attention(q, k, v, return_lse=True,
                                               **kw)
    assert _build.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert _build.LAUNCHES["flash_fwd_combine"] == \
        before["flash_fwd_combine"] + (splits > 1)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, **kw)
    finite = torch.isfinite(ref_lse)
    torch.cuda.synchronize()
    assert torch.equal(finite, torch.isfinite(lse))
    if kv_valid == 0:
        assert torch.all(out == 0)
        return
    _close(out, ref, torch.bfloat16)
    torch.testing.assert_close(lse[finite], ref_lse[finite], atol=1e-3,
                               rtol=0)


def test_flash_wide_combine_matches_plain(dev):
    """flash_fwd_combine against its plain version: rows empty in some
    splits, in every split, and a strided bf16 output."""
    g = torch.Generator(device=dev).manual_seed(62)
    splits, b, h, sq, d = 3, 2, 2, 50, 384
    part = torch.randn(splits, b, h, sq, d, generator=g, device=dev)
    lse_part = torch.randn(splits, b, h, sq, generator=g, device=dev) * 4
    lse_part[0, :, :, :10] = float("-inf")
    lse_part[:, 1, 0, 20:23] = float("-inf")
    part[lse_part.isinf()] = 0
    buf = torch.empty(b, sq, h, 2 * d, device=dev, dtype=torch.bfloat16)
    out = buf[..., d:]
    lse = torch.empty(b, h, sq, device=dev)
    flash_attention.wide_combine(part, lse_part, out, lse)
    ref, ref_lse = flash_attention.wide_combine_plain(part, lse_part)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=0,
                               rtol=2.0**-7)
    assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
    fin = torch.isfinite(ref_lse)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-5, rtol=0)
    assert torch.all(out[1, 20:23, 0] == 0)


def test_flash_wide_fp32_and_backward_keep_their_schedules(dev):
    """At a head of 384 fp32 takes its own (3xTF32) schedule and no
    backward runs: a bf16 call under grad raises before any launch."""
    assert _build.query("flash_fwd", "fvt_flash_fwd_sm90", 0, 384) == 3
    assert flash_attention.flash_bwd_schedule(384) == "tile"
    q = torch.randn(1, 64, 1, 384, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    before = dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelError, match="backward"):
        flash_attention.flash_attention(q, q, q)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("c,co,kt,time_pad,t,h,w", [
    (96, 96, 3, 0, 4, 6, 70),     # up3's conv: a W tail (16 x 8 patches)
    (96, 96, 3, 2, 1, 2, 64),     # the first chunk: 2 pad taps skipped
    (16, 384, 3, 2, 2, 5, 20),    # conv_in: four N tiles of 96
    (96, 3, 3, 0, 3, 9, 24),      # conv_out: an N tile of 8, odd Co
    (384, 192, 1, 0, 2, 8, 24),   # a resample: kt 1, two N tiles
    (192, 192, 3, 1, 2, 1, 128),  # 128 x 1 patches, one pad frame
    (8, 40, 3, 0, 3, 60, 104),    # channels padded to 16, a Co tail
])
def test_conv3d_tf32_matches_plain(dev, c, co, kt, time_pad, t, h, w):
    """K3's 3xTF32 schedule against the plain fp32 conv within chip_smoke's
    gate, 5e-5 + 1e-5 |plain|, at each N tile, patch shape and tail; the
    library's route and N tile are the host rule's, and the launch is
    counted."""
    assert _build.query("conv3d", "fvt_conv3d_route", 0, c, co) == 2
    assert _build.query("conv3d", "fvt_conv3d_tf32_tile_n", co) == \
        conv3d.conv_tf32_tile_n(co)
    g = torch.Generator(device=dev).manual_seed(63)
    x = torch.randn(1, t, h, w, c, generator=g, device=dev)
    wt = torch.randn(kt, 3, 3, c, co, generator=g, device=dev) * (
        kt * 9 * c)**-0.5
    b = torch.randn(co, generator=g, device=dev)
    before = _build.LAUNCHES["conv3d"]
    out = conv3d.conv3d_ndhwc(x, wt, b, time_pad=time_pad)
    assert _build.LAUNCHES["conv3d"] == before + 1
    ref = conv3d.conv3d_ndhwc_plain(x, wt, b, time_pad=time_pad)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=5e-5, rtol=1e-5)


# -- K1's fp32 form at a head of 384 (3xTF32) ----------------------------------


@pytest.mark.parametrize("b,sq,skv,h,causal,kv_valid,qkv", [
    (1, 6240, 6240, 1, False, None, True),   # the first decode chunk
    (2, 1000, 1000, 1, False, None, True),   # a ragged tile, 2 frames
    (2, 77, 130, 3, False, 60, False),       # kv_valid inside a chunk, B H 6
    (1, 300, 333, 2, True, None, False),     # causal, ragged chunks
    (1, 4000, 130, 8, False, None, False),   # one split: O written direct
    (1, 64, 96, 2, False, 0, False),         # every row empty
    (1, 100, 90, 1, False, None, False),     # keys past the last chunk
])
def test_flash_wide_tf32_matches_plain(dev, b, sq, skv, h, causal, kv_valid,
                                       qkv):
    """K1 on the 3xTF32 wide schedule (fp32, head 384) against the plain
    fp32 version within chip_smoke's gate, 1e-5 + 1e-4 |plain|, the LSE
    within 1e-4 (-inf on empty rows), from q/k/v column views of one qkv
    tensor as the VAE passes them or from strided views; the library's
    split rule is the host's, and the pre-pass, the kernel and (split)
    the merge each count one launch."""
    d = 384
    g = torch.Generator(device=dev).manual_seed(71)
    if qkv:
        t = torch.randn(b, sq, h, 3 * d, generator=g, device=dev)
        q, k, v = t[..., :d], t[..., d:2 * d], t[..., 2 * d:]
    else:
        q = torch.randn(b, sq, h, d, generator=g, device=dev)
        kv = torch.randn(b, skv, h, 2 * d, generator=g, device=dev)
        k, v = kv[..., d:], kv[..., :d]
    kw = dict(scale=d**-0.5, causal=causal,
              kv_valid=skv if kv_valid is None else kv_valid)
    splits = flash_attention.wide_splits(
        b, h, sq, min(kw["kv_valid"], skv), _build.num_sms(dev),
        flash_attention.TF32_BLOCK_ROWS)
    assert _build.query("flash_fwd", "fvt_flash_fwd_wide_tf32_splits", b, h,
                        sq, skv, kw["kv_valid"], _build.num_sms(dev)) == splits
    before = dict(_build.LAUNCHES)
    out, lse = flash_attention.flash_attention(q, k, v, return_lse=True,
                                               **kw)
    for name, n in (("flash_fwd_tf32", 1), ("flash_fwd_tf32_split", 1),
                    ("flash_fwd_combine", int(splits > 1)),
                    ("flash_fwd", 0)):
        assert _build.LAUNCHES[name] == before[name] + n, name
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    if kv_valid == 0:
        assert torch.all(out == 0)
        return
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(lse[finite], ref_lse[finite], atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("b,skv,h", [(2, 333, 3), (1, 6240, 1), (1, 8, 2)])
def test_flash_tf32_split_matches_plain(dev, b, skv, h):
    """The pre-pass equals its plain version bit for bit from strided
    views: K's and V^T's TF32 heads and tails, V^T's keys in
    tf32_key_order, zero past Skv."""
    g = torch.Generator(device=dev).manual_seed(72)
    kv = torch.randn(b, skv, h, 3 * 384, generator=g, device=dev)
    k, v = kv[..., 384:768], kv[..., 768:]
    before = _build.LAUNCHES["flash_fwd_tf32_split"]
    got = flash_attention.tf32_split_kv(k, v)
    assert _build.LAUNCHES["flash_fwd_tf32_split"] == before + 1
    want = flash_attention.tf32_split_plain(k, v)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.shape == w.shape and torch.equal(a, w)


def test_flash_wide_combine_f32_matches_plain(dev):
    """flash_fwd_combine's fp32 instance against its plain version: rows
    empty in some splits, in every split, and a strided fp32 output."""
    g = torch.Generator(device=dev).manual_seed(73)
    splits, b, h, sq, d = 3, 2, 2, 50, 384
    part = torch.randn(splits, b, h, sq, d, generator=g, device=dev)
    lse_part = torch.randn(splits, b, h, sq, generator=g, device=dev) * 4
    lse_part[0, :, :, :10] = float("-inf")
    lse_part[:, 1, 0, 20:23] = float("-inf")
    part[lse_part.isinf()] = 0
    buf = torch.empty(b, sq, h, 2 * d, device=dev)
    out = buf[..., d:]
    lse = torch.empty(b, h, sq, device=dev)
    flash_attention.wide_combine(part, lse_part, out, lse)
    ref, ref_lse = flash_attention.wide_combine_plain(part, lse_part,
                                                      torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-5)
    assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
    fin = torch.isfinite(ref_lse)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-5, rtol=0)
    assert torch.all(out[1, 20:23, 0] == 0)


def test_flash_fwd_entry_refuses_the_tf32_case(dev):
    """fp32 at a head of 384 has no other schedule: the plain entry
    fvt_flash_fwd refuses it (the wrapper routes it to the 3xTF32 one), so
    nothing falls back to attn_tile.cuh."""
    q = torch.zeros(1, 64, 1, 384, device=dev)
    o = torch.empty_like(q)
    st = flash_attention.bhs(q)
    err = _build.load("flash_fwd").fvt_flash_fwd(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(), None, 0, 1,
        1, 64, 64, 384, *st, *st, *st, *st, 384**-0.5, 0, 64,
        _build.stream_ptr(q))
    assert err != 0


@pytest.mark.parametrize("out_features", [1536, 8960])
def test_lora_linear_on_the_card_matches_the_cpu(dev, out_features):
    """``LoRALinear`` (rank 32, bf16 activations, fp32 masters) at a
    full-width Wan linear (1,536 in; the attention's 1,536 or the FFN's
    8,960 out) over 4,096 tokens: active, merged and unmerged on the card
    against the same layer on the CPU. Both sides round the products to
    bf16 (cuBLAS and the CPU sum in other orders): within 2 bf16 ulps
    (2^-6) relative plus 2^-6 of the output's std. The merged weight
    within 1e-6 of the CPU's (fp32), and unmerge restores the card's
    weight within 1e-6."""
    from fastvideo_tpu_torch.layers.linear import Linear
    from fastvideo_tpu_torch.layers.lora import LoRALinear

    g = torch.Generator().manual_seed(0)
    base = Linear(1536, out_features)
    with torch.no_grad():
        base.weight.copy_(torch.randn(base.weight.shape, generator=g)
                          / 1536**0.5)
    cpu = LoRALinear.from_linear(base, rank=32, alpha=64.0)
    cpu.set_adapter(torch.randn(32, 1536, generator=g) / 1536**0.5,
                    torch.randn(out_features, 32, generator=g) / 8)
    card = LoRALinear.from_linear(Linear(1536, out_features).to(dev),
                                  rank=32, alpha=64.0)
    card.load_state_dict(cpu.state_dict())
    card.lora_active = True
    x = torch.randn(1, 4096, 1536, generator=g).to(torch.bfloat16)
    w0 = card.weight.detach().clone()
    for stage in ("active", "merged", "unmerged"):
        if stage == "merged":
            cpu.merge()
            card.merge()
            torch.testing.assert_close(card.weight.cpu(), cpu.weight,
                                       atol=1e-6, rtol=0)
        elif stage == "unmerged":
            cpu.unmerge()
            card.unmerge()
            torch.testing.assert_close(card.weight, w0, atol=1e-6, rtol=0)
        with torch.no_grad():
            want = cpu(x).float()
            got = card(x.to(dev)).float()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), stage
        torch.testing.assert_close(got.cpu(), want,
                                   atol=2.0**-6 * want.std().item(),
                                   rtol=2.0**-6, msg=stage)
