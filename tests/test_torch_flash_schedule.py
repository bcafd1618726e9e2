"""The host side of the flash kernels' schedules, on the CPU: which schedule
a (dtype, head) takes, how many query-row splits the dK/dV grid gets and
the shape of their scratch, the plain version of the split reduction, and
that the Python rules and constants agree with the CUDA sources."""

import os
import re

import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import flash_attention as fa

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "fastvideo_tpu_torch", "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "sm90"),     # the tiny dfsft student
    (torch.bfloat16, 128, "sm90"),    # every full-width DiT attention
    (torch.bfloat16, 16, "tile"),     # the tiny models
    (torch.bfloat16, 32, "tile"),
    (torch.bfloat16, 96, "tile"),
    (torch.bfloat16, 384, "sm90_wide"),  # the VAE's attention
    (torch.float32, 64, "tile"),      # fp32 forms
    (torch.float32, 128, "tile"),
    (torch.float32, 384, "sm90_wide_tf32"),  # an fp32 decode
])
def test_flash_schedule(dtype, d, want):
    assert fa.flash_schedule(dtype, d) == want


@pytest.mark.parametrize("b,h,sq,skv,d,sms,want", [
    # the SFT / causal-training cross-attention: 4 key tiles x 12 heads =
    # 48 blocks for 132 SMs -> 11 splits, 528 blocks (4 waves)
    (1, 12, 32760, 512, 128, 132, 11),
    (1, 12, 65520, 512, 128, 132, 11),
    # the causal Wan's self-attention fills the card alone
    (1, 12, 32760, 32760, 128, 132, 1),
    (1, 12, 65520, 65520, 128, 132, 1),
    # at most one split a streamed 64-row step
    (1, 2, 180, 180, 64, 132, 3),
    (1, 2, 100, 12, 64, 132, 2),
    (1, 1, 64, 64, 128, 132, 1),
    # the first schedule never splits
    (1, 4, 512, 12, 16, 132, 1),
    (1, 2, 5000, 512, 96, 132, 1),
    # another card's SM count
    (1, 12, 32760, 512, 128, 114, 10),
    (2, 12, 32760, 512, 128, 132, 6),
])
def test_dkv_splits(b, h, sq, skv, d, sms, want):
    assert fa.dkv_splits(b, h, sq, skv, d, sms) == want


def test_dkv_splits_fill_the_card_and_scratch_shape():
    for skv in (12, 128, 512, 1000):
        for h in (1, 2, 12):
            blocks = h * -(-skv // fa.DKV_BLOCK_KEYS)
            n = fa.dkv_splits(1, h, 40000, skv, 128, 132)
            if blocks < 132:
                assert n * blocks >= fa.DKV_SPLIT_WAVES * 132
            else:
                assert n == 1
    assert fa.dkv_scratch_shape(11, 1, 12, 512, 128) == (11, 1, 12, 512, 128)


def test_dkv_reduce_plain_adds_splits_in_order():
    rng = np.random.default_rng(3)
    part_k, part_v = (torch.from_numpy(rng.standard_normal(
        (5, 2, 3, 70, 64)).astype(np.float32)) for _ in range(2))
    before = _build.PLAIN_CALLS[fa.NAME_BWD_REDUCE]
    dk, dv = fa.dkv_reduce_plain(part_k, part_v)
    assert _build.PLAIN_CALLS[fa.NAME_BWD_REDUCE] == before + 1
    for got, part in ((dk, part_k), (dv, part_v)):
        assert got.shape == (2, 70, 3, 64) and got.dtype == torch.bfloat16
        acc = part[0].clone()
        for z in range(1, 5):
            acc += part[z]
        assert torch.equal(got, acc.to(torch.bfloat16).transpose(1, 2))


def test_cpu_backward_takes_no_reduce():
    """On CPU tensors the backward is the plain version: no split, no
    reduce, whatever dkv_splits says for the shape on a card."""
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, s, 2, 64)).astype(np.float32)).to(torch.bfloat16)
                   for s in (150, 40, 40, 150))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    before = dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)
    fa.flash_attention_bwd(q, k, v, out, lse, do, scale=0.125)
    assert _build.PLAIN_CALLS[fa.NAME_BWD_REDUCE] == before[0][
        fa.NAME_BWD_REDUCE]
    assert _build.LAUNCHES == before[1]


def test_host_rules_match_the_sources():
    """The Python constants and rules are the CUDA sources' own."""
    bwd = _source("flash_bwd_sm90.cuh")
    assert int(re.search(r"kBwdOwn = (\d+)", bwd).group(1)) == \
        fa.DKV_BLOCK_KEYS
    assert int(re.search(r"kBwdStep = (\d+)", bwd).group(1)) == \
        fa.DKV_STEP_ROWS
    for src, args in (("flash_fwd.cu", r"int dtype, int D"),
                      ("flash_bwd.cu", r"int D")):
        rule = re.search(r"bool use_sm90\(" + args + r"\) \{[^}]*\}",
                         _source(src)).group(0)
        heads = tuple(sorted(int(x) for x in re.findall(r"D == (\d+)", rule)))
        assert heads == fa.SM90_HEADS, src
    assert "flash_bwd_dkv_reduce" in _build.KERNELS
    assert _build.SOURCE_OF["flash_bwd_dkv_reduce"] == "flash_bwd"
    assert set(_build.PTXAS_VERBOSE) == {"flash_fwd", "flash_bwd",
                                         "vsa_sparse_bwd", "dyn_sparse_fwd",
                                         "vsa_sparse_padded_fwd", "conv3d",
                                         "vsa_sparse_fwd", "conv3d_int8"}


def test_ptxas_report_parses_a_log(tmp_path, monkeypatch):
    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN3fvt4sm9014flash_fwd_sm90ILi128ELi0EEEvNS0_9FwdParamsE' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _ZN3fvt4sm9014flash_fwd\n"
        "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 186 registers, used 1 barriers, 464 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN1a6kernelEv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _ZN1a6kernelEv\n"
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 1024 bytes smem, 360 bytes "
        "cmem[0]\n")
    monkeypatch.setattr(_build, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(_build, "build_all", lambda: {})
    (tmp_path / "flash_fwd.ptxas.txt").write_text(log)
    got = _build.ptxas_report("flash_fwd")
    assert got == [
        {"kernel": "_ZN3fvt4sm9014flash_fwd_sm90ILi128ELi0EEEvNS0_9FwdParamsE",
         "registers": 186, "spill_stores": 0, "spill_loads": 0, "stack": 32,
         "smem": 0, "warnings": []},
        {"kernel": "_ZN1a6kernelEv", "registers": 40, "spill_stores": 4,
         "spill_loads": 8, "stack": 8, "smem": 1024, "warnings": []}]
