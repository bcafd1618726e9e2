"""The port imports nothing of JAX, Flax or the JAX package, and its CUDA
wrappers never fall back to the plain versions."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import fastvideo_tpu  # noqa: F401  (the JAX reference stays importable)
import fastvideo_tpu_torch
from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import bsa, conv3d, flash_attention, nabla, vsa

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(fastvideo_tpu_torch.__file__)
FORBIDDEN = ("jax", "jaxlib", "flax", "fastvideo_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_forbidden_import_in_sources():
    bad = []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad


def test_no_package_the_card_lacks_in_sources():
    """The card's machine has none of these: the port reads Parquet,
    safetensors and tokenizer.json files, and splits graphemes, itself."""
    absent = ("pyarrow", "tokenizers", "regex", "transformers",
              "safetensors", "sentencepiece", "PIL")
    bad = []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names
                    if n.split(".")[0] in absent]
    assert not bad


# the LoRA / kd / AnyFlow slice: each of its modules stands alone (its
# own LoRA key mapping, flow-map scheduler and safetensors key reader)
SLICE_MODULES = [
    "layers/lora.py", "pipelines/lora_pipeline.py",
    "training/methods/lora.py", "training/methods/knowledge_distillation.py",
    "training/methods/anyflow_pretrain.py", "training/methods/anyflow.py",
    "models/schedulers/scheduling_flow_map_euler.py",
    # the DiffusionNFT slice: CLIP towers and scorer, the BPE reader, the RL
    # method, callbacks, _target_ instantiation
    "configs/models/encoders/clip.py", "models/encoders/clip.py",
    "models/clip_scoring.py", "models/loader/tokenizer.py",
    "training/rl/__init__.py", "training/rl/rewards.py",
    "training/rl/sampling.py", "training/rl/diffusion_nft.py",
    "training/methods/rl.py", "training/instantiate.py",
    "training/callbacks.py", "training/training_utils.py",
]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_imports_nothing_forbidden(module):
    path = os.path.join(PKG, module)
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert names and not [n for n in names if _forbidden(n)
                          or n.split(".")[0] == "safetensors"]


BLOCKER = """
import importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in {forbidden!r}):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import fastvideo_tpu_torch
from fastvideo_tpu_torch import VideoGenerator
for mod in pkgutil.walk_packages(fastvideo_tpu_torch.__path__,
                                 "fastvideo_tpu_torch."):
    __import__(mod.name)
assert not [m for m in sys.modules
            if any(m == f or m.startswith(f + ".") for f in {forbidden!r})]
print("ok")
"""


TARGETS = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
from fastvideo_tpu_torch.training.callbacks import CallbackDict
from fastvideo_tpu_torch.training.instantiate import instantiate
from fastvideo_tpu_torch.training.methods import resolve_method
cls = resolve_method("fastvideo_tpu.training.methods.rl.DiffusionNFTMethod")
assert cls.name == "diffusion_nft"
cbs = CallbackDict({"e": {
    "_target_": "fastvideo_tpu.training.callbacks.EMACallback"}})
assert type(cbs["e"]).__module__ == "fastvideo_tpu_torch.training.callbacks"
clip = instantiate({"_target_": "fastvideo_tpu.training.callbacks."
                    "GradNormClipCallback", "max_grad_norm": 0.5})
assert clip.max_grad_norm == 0.5
assert not [m for m in sys.modules
            if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
print("ok")
"""


def test_target_paths_resolve_with_jax_blocked():
    """A dotted ``_target_`` under ``fastvideo_tpu.`` (a method, a callback,
    ``instantiate``) resolves in the port's package with JAX, Flax and the
    JAX package blocked, and none of them enters ``sys.modules``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c",
         TARGETS.replace("FORBIDDEN", repr(FORBIDDEN))],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to drive the
    wrappers' CUDA dispatch without a card."""

    @property
    def is_cuda(self):
        return True


def _cuda_typed(t):
    return t.as_subclass(_CudaTyped)


def _calls():
    bf = torch.bfloat16
    q = torch.zeros(1, 64, 2, 32, dtype=bf)
    qt = torch.zeros(1, 2, 128, 32, dtype=bf)
    idx = torch.zeros(1, 2, 2, 1, dtype=torch.int32)
    sizes = torch.full((2,), 64, dtype=torch.int32)
    x = torch.zeros(1, 2, 4, 4, 8, dtype=bf)
    w = torch.zeros(3, 3, 3, 8, 8, dtype=bf)
    b = torch.zeros(8, dtype=bf)
    xq = torch.zeros(1, 2, 4, 4, 32, dtype=torch.int8)
    wq = torch.zeros(3, 3, 3, 32, 32, dtype=torch.int8)
    scale = torch.ones(32)
    lse = torch.zeros(1, 2, 64)
    lse_t = torch.zeros(1, 2, 128)
    part = torch.zeros(2, 1, 2, 64, 32)  # dK/dV partial sums of 2 splits
    # the wide K1's partials of 2 key splits at a head of 384, and its output
    wide = torch.zeros(2, 1, 2, 64, 384), torch.zeros(2, 1, 2, 64)
    wide_out = torch.zeros(1, 64, 2, 384, dtype=bf)
    q384 = torch.zeros(1, 64, 1, 384)  # the fp32 VAE attention's head
    c = _cuda_typed

    def flash_bwd():
        return flash_attention.flash_attention_bwd(
            c(q), c(q), c(q), c(q), lse, c(q), scale=0.125)

    def flash_bwd_struct():
        return flash_attention.flash_attention_bwd(
            c(q), c(q), c(q), c(q), lse, c(q), scale=0.125, chunk_tokens=16,
            tf_clean_len=32)

    def vsa_bwd():
        return vsa.block_sparse_attention_bwd(
            c(qt), c(qt), c(qt), idx, sizes, c(qt), lse_t, c(qt),
            scale=0.125, tile_elems=64)

    return {
        "flash_fwd": lambda: flash_attention.flash_attention(c(q), c(q), c(q)),
        "flash_fwd_kv_mask": lambda: flash_attention.flash_attention_kv_mask(
            c(q), c(q), c(q), c(torch.ones(q.shape[1], dtype=torch.bool))),
        "vsa_sparse_fwd": lambda: vsa.block_sparse_attention_fast(
            c(qt), c(qt), c(qt), idx, tile_elems=64),
        "vsa_sparse_padded_fwd": lambda: vsa.block_sparse_attention(
            c(qt), c(qt), c(qt), idx, sizes),
        "conv3d": lambda: conv3d.conv3d_ndhwc(c(x), c(w), c(b), time_pad=2),
        "conv3d_int8": lambda: conv3d.conv3d_int8(
            c(xq), c(wq), scale, scale, time_pad=2, out_dtype=bf),
        "flash_bwd_dq": flash_bwd,
        "flash_bwd_dkv": flash_bwd,
        "vsa_sparse_bwd_dq": vsa_bwd,
        "vsa_sparse_bwd_dkv": vsa_bwd,
        "dyn_sparse_fwd": lambda: nabla.masked_block_sparse_attention(
            c(qt), c(qt), c(qt), torch.ones(1, 2, 2, 2, dtype=torch.bool),
            sizes),
        "dyn_sparse_qtile_fwd": lambda: bsa._masked_sparse_qtile(
            c(qt[:, :, :64]), c(qt), c(qt),
            torch.ones(1, 2, 2, 2, dtype=torch.bool), sizes, 32, scale=0.125),
        "flash_fwd_struct": lambda: flash_attention.flash_attention(
            c(q), c(q), c(q), chunk_tokens=16),
        "flash_bwd_struct_dq": flash_bwd_struct,
        "flash_bwd_struct_dkv": flash_bwd_struct,
        "flash_bwd_dkv_reduce": lambda: flash_attention.dkv_reduce(
            c(part), c(part), c(q), c(q)),
        "flash_fwd_combine": lambda: flash_attention.wide_combine(
            c(wide[0]), c(wide[1]), c(wide_out), None),
        "flash_fwd_tf32": lambda: flash_attention.flash_attention(
            c(q384), c(q384), c(q384)),
        "flash_fwd_tf32_split": lambda: flash_attention.tf32_split_kv(
            c(q384), c(q384)),
    }


@pytest.mark.parametrize("kernel", _build.KERNELS)
def test_cuda_call_without_kernel_library_raises(kernel, monkeypatch,
                                                 tmp_path):
    """With no library loaded and no nvcc, a CUDA-typed call raises a
    KernelError from the build; the plain version never runs."""
    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("FASTVIDEO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    before = dict(_build.PLAIN_CALLS)
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        _calls()[kernel]()
    assert _build.PLAIN_CALLS == before


@pytest.mark.parametrize("kernel", _build.KERNELS)
def test_cuda_call_on_other_card_raises(kernel, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    before = dict(_build.PLAIN_CALLS)
    with pytest.raises(_build.KernelError, match="sm_90a"):
        _calls()[kernel]()
    assert _build.PLAIN_CALLS == before


@pytest.mark.parametrize("padded", [False, True],
                         ids=["full_tiles", "padded_tiles"])
@pytest.mark.parametrize("dtype,d", [(torch.float32, 32),
                                     (torch.bfloat16, 256)])
def test_vsa_cuda_call_rejects_other_dtypes_and_head_dims(dtype, d, padded,
                                                          monkeypatch):
    """The sparse kernels are built for bf16 with head dims up to 128 only;
    other CUDA calls raise before any build, and the plain version never
    runs."""
    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    qt = _cuda_typed(torch.zeros(1, 2, 128, d, dtype=dtype))
    idx = torch.zeros(1, 2, 2, 1, dtype=torch.int32)
    before = dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelError, match="bfloat16"):
        if padded:
            vsa.block_sparse_attention(
                qt, qt, qt, idx, torch.full((2,), 64, dtype=torch.int32))
        else:
            vsa.block_sparse_attention_fast(qt, qt, qt, idx, tile_elems=64)
    assert (dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)) == before


def test_padded_cuda_call_refuses_tensors_that_require_grad(monkeypatch):
    """The padded kernel has no backward yet: a CUDA call on tensors that
    require grad raises instead of returning a result with no graph."""
    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    qt = _cuda_typed(torch.zeros(1, 2, 128, 32, dtype=torch.bfloat16))
    qg = _cuda_typed(torch.zeros(1, 2, 128, 32, dtype=torch.bfloat16,
                                 requires_grad=True))
    idx = torch.zeros(1, 2, 2, 1, dtype=torch.int32)
    sizes = torch.full((2,), 64, dtype=torch.int32)
    before = dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelError, match="backward"):
        vsa.block_sparse_attention(qg, qt, qt, idx, sizes)
    assert (dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)) == before


@pytest.mark.parametrize("path", ["video_sparse_attn", "sta", "sla"])
def test_sparse_paths_reach_the_padded_kernel_on_cuda(path, monkeypatch):
    """VSA on a grid with no exact tile, STA and SLA go to the padded
    kernel's launch on a CUDA tensor (here: its build, which has no nvcc)
    and never to the plain version."""
    from fastvideo_tpu_torch.ops import sla, sta

    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    bf = torch.bfloat16
    c = _cuda_typed
    before = dict(_build.PLAIN_CALLS)
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        if path == "video_sparse_attn":
            q = c(torch.zeros(1, 2, 128, 32, dtype=bf))
            vsa.video_sparse_attn(q, q, q, torch.tensor([64, 40]), 1)
        elif path == "sta":
            q = c(torch.zeros(1, 3 * 5 * 6, 2, 32, dtype=bf))
            sta.sliding_tile_attention(q, q, q, (3, 5, 6), ((3, 3, 3),) * 2,
                                       (2, 2, 4))
        else:
            q = c(torch.zeros(1, 128, 2, 32, dtype=bf))
            sla.sla_attention(q, q, q, topk_ratio=0.5)
    assert _build.PLAIN_CALLS == before


def _grad_calls():
    """CUDA-typed calls of the wrappers with no backward, on operands that
    require grad."""
    bf = torch.bfloat16
    c = _cuda_typed

    def leaf(*shape, dtype=bf):
        return c(torch.zeros(*shape, dtype=dtype, requires_grad=True))

    q = torch.zeros(1, 64, 2, 32, dtype=bf)
    qt = torch.zeros(1, 2, 128, 32, dtype=bf)
    idx = torch.zeros(1, 2, 2, 1, dtype=torch.int32)
    sizes = torch.full((2,), 64, dtype=torch.int32)
    w = torch.zeros(3, 3, 3, 32, 32, dtype=bf)
    b = torch.zeros(32, dtype=bf)
    return {
        "flash_fwd_kv_mask": lambda: flash_attention.flash_attention_kv_mask(
            leaf(1, 64, 2, 32), c(q), c(q),
            c(torch.ones(64, dtype=torch.bool))),
        "vsa_sparse_fwd": lambda: vsa.block_sparse_attention_fast(
            leaf(1, 2, 128, 32), c(qt), c(qt), idx, tile_elems=64),
        "vsa_sparse_padded_fwd": lambda: vsa.block_sparse_attention(
            leaf(1, 2, 128, 32), c(qt), c(qt), idx, sizes),
        "conv3d": lambda: conv3d.conv3d_ndhwc(
            leaf(1, 2, 4, 16, 32), c(w), c(b), time_pad=2),
        "conv3d_int8": lambda: conv3d.conv3d_ndhwc(
            leaf(1, 2, 4, 16, 32), c(w), c(b), time_pad=2, mode="kf_int8"),
        "flash_fwd_fp32": lambda: flash_attention.flash_attention(
            leaf(1, 64, 2, 32, dtype=torch.float32),
            c(q.float()), c(q.float())),
        "dyn_sparse_fwd": lambda: nabla.masked_block_sparse_attention(
            leaf(1, 2, 128, 32), c(qt), c(qt), idx[..., :1] >= 0, sizes),
        "dyn_sparse_qtile_fwd": lambda: bsa._masked_sparse_qtile(
            leaf(1, 2, 16, 32), c(qt), c(qt),
            torch.ones(1, 2, 2, 2, dtype=torch.bool), sizes, 8, scale=0.125),
    }


@pytest.mark.parametrize("kind", list(_grad_calls()))
def test_cuda_wrappers_without_backward_refuse_grad(kind, monkeypatch):
    """A CUDA wrapper with no backward (K2, K5, K8, K3, K4, K9a, K9b, and
    K1 in fp32, which K6 does not take) raises for operands that require
    grad, before
    any build or launch, instead of returning an output with no grad_fn;
    the plain version never runs."""
    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    before = dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelError, match="backward"):
        _grad_calls()[kind]()
    assert (dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)) == before


@pytest.mark.parametrize("path", ["flash", "vsa_fast", "vsa_padded"])
def test_cuda_grad_paths_go_to_the_trainable_kernels(path, monkeypatch):
    """Under grad K1 and VSA on full and on padded tiles take the autograd
    Functions whose forward is a kernel launch (here: its build, which has
    no nvcc): never a plain version, never K2."""
    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    bf = torch.bfloat16
    c = _cuda_typed
    q = c(torch.zeros(1, 2, 256, 32, dtype=bf, requires_grad=True))
    sizes = torch.full((4,), 64, dtype=torch.int32)
    calls = {
        "flash": lambda: flash_attention.flash_attention(
            c(torch.zeros(1, 64, 2, 32, dtype=bf, requires_grad=True)),
            c(torch.zeros(1, 64, 2, 32, dtype=bf)),
            c(torch.zeros(1, 64, 2, 32, dtype=bf))),
        "vsa_fast": lambda: vsa.video_sparse_attn(
            q, q, q, sizes, 2, tile_elems=64, full_tiles=True, q_group=2),
        "vsa_padded": lambda: vsa.video_sparse_attn(
            q, q, q, sizes, 2, tile_elems=64, full_tiles=False),
    }
    before = dict(_build.PLAIN_CALLS)
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        calls[path]()
    assert _build.PLAIN_CALLS == before


@pytest.mark.parametrize("dtype,d", [(torch.float32, 32),
                                     (torch.bfloat16, 256)])
@pytest.mark.parametrize("kernel", ["dyn_sparse_fwd", "dyn_sparse_qtile_fwd"])
def test_dyn_sparse_cuda_call_rejects_other_dtypes_and_head_dims(
        kernel, dtype, d, monkeypatch):
    """K9a / K9b are built for bf16 with head dims up to 128 only; other
    CUDA calls raise before any build, and the plain version never runs."""
    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    qt = _cuda_typed(torch.zeros(1, 2, 128, d, dtype=dtype))
    mask = torch.ones(1, 2, 2, 2, dtype=torch.bool)
    sizes = torch.full((2,), 64, dtype=torch.int32)
    before = dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelError, match="bfloat16"):
        if kernel == "dyn_sparse_fwd":
            nabla.masked_block_sparse_attention(qt, qt, qt, mask, sizes)
        else:
            bsa._masked_sparse_qtile(qt[:, :, :64], qt, qt, mask, sizes, 32,
                                     scale=0.125)
    assert (dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)) == before


@pytest.mark.parametrize("backend", ["NABLA_ATTN", "BSA_ATTN"])
def test_nabla_and_bsa_reach_their_kernels_on_cuda(backend, monkeypatch):
    """The NABLA_ATTN and BSA_ATTN backends go to K9a / K9b's launch on a
    CUDA tensor (here: its build, which has no nvcc), never to the plain
    version."""
    from fastvideo_tpu_torch.attention.selector import get_attn_backend

    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    be = get_attn_backend(2, 32, requested=backend)
    rng = torch.Generator().manual_seed(0)
    q = _cuda_typed(torch.randn(1, 4 * 8 * 8, 2, 32, generator=rng,
                                dtype=torch.bfloat16))
    before = dict(_build.PLAIN_CALLS)
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        be.forward(q, q, q, grid=(4, 8, 8))
    assert _build.PLAIN_CALLS == before


def test_causal_distillation_modules_are_walked():
    """The causal distillation methods' modules (self-forcing, streaming
    long tuning, causal consistency distillation and its scheduler) are
    among the sources the import checks read."""
    paths = {os.path.relpath(p, PKG) for p in _port_sources()}
    assert {"training/self_forcing_pipeline.py",
            "training/streaming_long_pipeline.py",
            "training/methods/causal_cd.py",
            "models/schedulers/scheduling_self_forcing_flow_match.py"
            } <= paths
