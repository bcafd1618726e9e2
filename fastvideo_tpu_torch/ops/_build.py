"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), loaded
with ctypes. All sources build in parallel at first use into
``build/kernels/<hash>/`` beside the package, keyed by a hash of every
source and header, so an edited kernel rebuilds and an unchanged one is
reused. Nothing builds when the module is imported.

Every kernel wrapper calls :func:`count_launch` where it launches its
kernel and :func:`count_plain` where it runs its plain PyTorch version, so
a run can show which path the work took. A kernel is counted by its own
name even where it shares a source with another (K5, ``flash_fwd_kv_mask``,
and K1 struct, ``flash_fwd_struct``, are entries of ``flash_fwd.cu``; the
backward sources hold a dQ and a dK/dV kernel each, ``flash_bwd_dq`` /
``flash_bwd_dkv`` (K6), ``flash_bwd_struct_dq`` / ``flash_bwd_struct_dkv``
(K6 struct) and ``vsa_sparse_bwd_dq`` / ``vsa_sparse_bwd_dkv`` (K7 bwd);
``flash_bwd_dkv_reduce`` adds a split dK/dV launch's partial sums,
``flash_fwd_combine`` merges a split wide K1 launch's partials, and K1's
fp32 form at a head of 384 counts as ``flash_fwd_tf32``, its pre-pass as
``flash_fwd_tf32_split``).

The sources with Hopper schedules (the flash and sparse attention kernels,
the convs K3 and K4) compile with ``-Xptxas -v``; :func:`ptxas_report` reads back
each of their kernels' registers, spills, static shared memory and ptxas
warnings (C7518: wgmma serialized).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# one shared library per csrc/<name>.cu
SOURCES = ("flash_fwd", "vsa_sparse_fwd", "vsa_sparse_padded_fwd", "conv3d",
           "conv3d_int8", "flash_bwd", "vsa_sparse_bwd", "dyn_sparse_fwd")
# counted kernels -> the source that holds them (each backward source holds
# a dQ and a dK/dV kernel, counted apart; dyn_sparse_fwd.cu holds K9a and
# K9b, the query-tile form; K1 struct and K6 struct, the causal Wan
# training masks, are instances of flash_fwd.cu and flash_bwd.cu)
SOURCE_OF = {**{n: n for n in SOURCES[:5]}, "flash_fwd_kv_mask": "flash_fwd",
             "flash_bwd_dq": "flash_bwd", "flash_bwd_dkv": "flash_bwd",
             "vsa_sparse_bwd_dq": "vsa_sparse_bwd",
             "vsa_sparse_bwd_dkv": "vsa_sparse_bwd",
             "dyn_sparse_fwd": "dyn_sparse_fwd",
             "dyn_sparse_qtile_fwd": "dyn_sparse_fwd",
             "flash_fwd_struct": "flash_fwd",
             "flash_bwd_struct_dq": "flash_bwd",
             "flash_bwd_struct_dkv": "flash_bwd",
             "flash_bwd_dkv_reduce": "flash_bwd",
             "flash_fwd_combine": "flash_fwd",
             "flash_fwd_tf32": "flash_fwd",
             "flash_fwd_tf32_split": "flash_fwd"}
KERNELS = tuple(SOURCE_OF)
# sources whose ptxas resource report is kept beside their library
PTXAS_VERBOSE = ("flash_fwd", "flash_bwd", "vsa_sparse_bwd", "dyn_sparse_fwd",
                 "vsa_sparse_padded_fwd", "conv3d", "vsa_sparse_fwd",
                 "conv3d_int8")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
PLAIN_CALLS: dict[str, int] = {name: 0 for name in KERNELS}
BUILD_SECONDS: float | None = None


class KernelError(RuntimeError):
    """A kernel could not be built, loaded or launched."""


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def count_plain(name: str) -> None:
    PLAIN_CALLS[name] += 1


def reset_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
        PLAIN_CALLS[name] = 0


def build_dir() -> str:
    root = os.environ.get("FASTVIDEO_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(CSRC)), "build", "kernels")
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as fh:
                h.update(fn.encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS + PTXAS_VERBOSE).encode())
    return os.path.join(root, h.hexdigest()[:16])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_all() -> dict[str, str]:
    """Compile every kernel that is not built yet, one nvcc per source, all
    started together. Returns {name: path of its shared library}."""
    global BUILD_SECONDS
    import time

    out_dir = build_dir()
    paths = {n: os.path.join(out_dir, f"lib{n}.so") for n in SOURCES}
    todo = [n for n in SOURCES if not os.path.exists(paths[n])]
    t0 = time.perf_counter()
    if todo:
        nvcc = _nvcc()
        os.makedirs(out_dir, exist_ok=True)
        procs = {}
        for n in todo:
            tmp = paths[n] + f".tmp{os.getpid()}"
            verbose = ("-Xptxas", "-v") if n in PTXAS_VERBOSE else ()
            cmd = [nvcc, *NVCC_FLAGS, *verbose, "-o", tmp,
                   os.path.join(CSRC, f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT,
                                              text=True))
        errors = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{log}")
            else:
                if n in PTXAS_VERBOSE:
                    with open(_report_path(out_dir, n), "w") as fh:
                        fh.write(log)
                os.replace(tmp, paths[n])
        if errors:
            raise KernelError("\n".join(errors))
    BUILD_SECONDS = time.perf_counter() - t0
    return paths


def _report_path(out_dir: str, name: str) -> str:
    return os.path.join(out_dir, f"{name}.ptxas.txt")


def ptxas_report(name: str) -> list[dict]:
    """Per-kernel resources of source ``name`` (one of ``PTXAS_VERBOSE``),
    from the ``-Xptxas -v`` log of its build: [{"kernel": mangled name,
    "registers", "spill_stores", "spill_loads", "stack", "smem",
    "warnings"}] (bytes; smem is the static shared memory, dynamic memory
    is set per launch; warnings are ptxas's coded notes on the kernel, such
    as "C7518: Potential Performance Loss: wgmma.mma_async instructions are
    serialized ...")."""
    build_all()
    with open(_report_path(build_dir(), name)) as fh:
        return parse_ptxas(fh.read())


def parse_ptxas(log: str) -> list[dict]:
    """:func:`ptxas_report` of one ``-Xptxas -v`` log. A coded note names
    its kernel ("in the function '<name>'") or belongs to the entry being
    compiled."""
    import re

    out, cur, notes = [], None, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "spill_stores": 0,
                   "spill_loads": 0, "stack": 0, "smem": 0, "warnings": []}
            out.append(cur)
            continue
        m = re.search(r"\((C\d+)\)\s*(.*)", line)
        if m:
            fn = re.search(r"function '([^']+)'", m.group(2))
            notes.append((fn.group(1) if fn else cur and cur["kernel"],
                          f"{m.group(1)}: {m.group(2).strip()}"))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    by_name = {r["kernel"]: r for r in out}
    for kernel, text in notes:
        if kernel in by_name:
            by_name[kernel]["warnings"].append(text)
    return out


_SMS: dict[int, int] = {}


def num_sms(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    idx = (device.index if device.index is not None else
           torch.cuda.current_device())
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SMS[idx]

_SIGNATURES = {
    # dtype, D: K1's schedule (1 the Hopper one, 2 the wide one, 3 the
    # 3xTF32 wide one, 0 the first)
    "fvt_flash_fwd_sm90": [ctypes.c_int] * 2,
    # B, H, Sq, Skv, kv_valid, SMs: the wide schedule's key splits; its
    # shared memory
    "fvt_flash_fwd_wide_splits": [ctypes.c_int] * 6,
    "fvt_flash_fwd_wide_smem": [],
    # q, k, v, o, lse, part, lse_part, B, H, Sq, Skv, 12 strides, scale,
    # causal, kv_valid, splits, stream
    "fvt_flash_fwd_wide": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 +
    [ctypes.c_longlong] * 12 + [ctypes.c_float] + [ctypes.c_int] * 3 +
    [ctypes.c_void_p],
    # part, lse_part, o, lse, splits, B, H, Sq, 3 strides, stream (bf16 o;
    # _f32: fp32 o)
    "fvt_flash_fwd_combine": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 +
    [ctypes.c_longlong] * 3 + [ctypes.c_void_p],
    "fvt_flash_fwd_combine_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 +
    [ctypes.c_longlong] * 3 + [ctypes.c_void_p],
    # B, H, Sq, Skv, kv_valid, SMs: the 3xTF32 wide schedule's key splits;
    # its shared memory
    "fvt_flash_fwd_wide_tf32_splits": [ctypes.c_int] * 6,
    "fvt_flash_fwd_wide_tf32_smem": [],
    # k, v, k_hi, k_lo, vt_hi, vt_lo, B, H, Skv, Skv_pad, 6 strides, stream
    "fvt_flash_tf32_split": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 +
    [ctypes.c_longlong] * 6 + [ctypes.c_void_p],
    # q, k_hi, k_lo, vt_hi, vt_lo, o, lse, part, lse_part, B, H, Sq, Skv,
    # Skv_pad, 6 strides, scale, causal, kv_valid, splits, stream
    "fvt_flash_fwd_wide_tf32": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 +
    [ctypes.c_longlong] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3 +
    [ctypes.c_void_p],
    # D: 1 when the flash backward runs its Hopper schedule
    "fvt_flash_bwd_sm90": [ctypes.c_int],
    # D, mode (0 K1, 1 K5, 2 K1 struct), Skv: the Hopper forward's dynamic
    # shared memory; kind (0 dQ, 1 dK/dV), D, struct: the backward's
    "fvt_flash_fwd_sm90_smem": [ctypes.c_int] * 3,
    "fvt_flash_bwd_sm90_smem": [ctypes.c_int] * 3,
    # q, k, v, dO, lse, delta, part_k, part_v, B, H, Sq, Skv, D, 12 strides,
    # scale, causal, kv_valid, chunk_tokens, tf_clean_len, splits, stream
    "fvt_flash_bwd_dkv_split": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 +
    [ctypes.c_longlong] * 12 + [ctypes.c_float] + [ctypes.c_int] * 5 +
    [ctypes.c_void_p],
    # part_k, part_v, dk, dv, splits, B, H, Skv, D, 6 strides, stream
    "fvt_flash_bwd_dkv_reduce": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 +
    [ctypes.c_longlong] * 6 + [ctypes.c_void_p],
    # q, k, v, o, lse, dtype, B, H, Sq, Skv, D, 12 strides, scale, causal,
    # kv_valid, stream
    "fvt_flash_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 +
    [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p],
    # q, k, v, o, lse, dtype, B, H, Sq, Skv, D, 12 strides, scale, kv_valid,
    # chunk_tokens, tf_clean_len, stream
    "fvt_flash_fwd_struct": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 +
    [ctypes.c_longlong] * 12 + [ctypes.c_float] + [ctypes.c_int] * 3 +
    [ctypes.c_void_p],
    # q, k, v, o, lse, kv_mask (uint8 [Skv]), dtype, B, H, Sq, Skv, D,
    # 12 strides, scale, stream
    "fvt_flash_fwd_kv_mask": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 +
    [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p],
    # q, k, v, o, indices, B, H, S, D, E, ng, topk, 12 strides, scale,
    # stream
    "fvt_vsa_sparse_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 +
    [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p],
    # the same with the key walk (0 per tile, 1 the stream) after topk
    "fvt_vsa_sparse_fwd_sm90": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 +
    [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p],
    # D: 1 when K2 runs its Hopper schedule; E: 1 when it walks the keys
    # as one stream; D, topk: its shared memory
    "fvt_vsa_sparse_fwd_route": [ctypes.c_int],
    "fvt_vsa_sparse_fwd_walk": [ctypes.c_int],
    "fvt_vsa_sparse_fwd_sm90_smem": [ctypes.c_int] * 2,
    # q, k, v, o, lse (or null), indices, block_sizes, B, H, S, D, E, topk,
    # 12 strides, scale, stream
    "fvt_vsa_sparse_padded_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 +
    [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p],
    # q, k, v, dO, lse, delta, dq, B, H, Sq, Skv, D, 15 strides, scale,
    # causal, kv_valid, stream
    "fvt_flash_bwd_dq": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 +
    [ctypes.c_longlong] * 15 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p],
    # q, k, v, dO, lse, delta, dk, dv, B, H, Sq, Skv, D, 18 strides, scale,
    # causal, kv_valid, stream
    "fvt_flash_bwd_dkv": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 +
    [ctypes.c_longlong] * 18 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p],
    # q, k, v, dO, lse, delta, dq, B, H, Sq, Skv, D, 15 strides, scale,
    # kv_valid, chunk_tokens, tf_clean_len, stream
    "fvt_flash_bwd_struct_dq": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 +
    [ctypes.c_longlong] * 15 + [ctypes.c_float] + [ctypes.c_int] * 3 +
    [ctypes.c_void_p],
    # q, k, v, dO, lse, delta, dk, dv, B, H, Sq, Skv, D, 18 strides, scale,
    # kv_valid, chunk_tokens, tf_clean_len, stream
    "fvt_flash_bwd_struct_dkv": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 +
    [ctypes.c_longlong] * 18 + [ctypes.c_float] + [ctypes.c_int] * 3 +
    [ctypes.c_void_p],
    # q, k, v, dO, lse, delta, dq, indices, block_sizes, B, H, S, D, E, topk,
    # 15 strides, scale, stream
    "fvt_vsa_sparse_bwd_dq": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 +
    [ctypes.c_longlong] * 15 + [ctypes.c_float, ctypes.c_void_p],
    # D: 1 when K7 bwd runs its Hopper schedule; kind (0 dQ, 1 dK/dV), D,
    # slots or tiles: that schedule's dynamic shared memory
    "fvt_vsa_sparse_bwd_sm90": [ctypes.c_int],
    "fvt_vsa_sparse_bwd_sm90_smem": [ctypes.c_int] * 3,
    # q, k, v, dO, lse, delta, dk, dv, t_list, t_counts, order, block_sizes,
    # B, H, S, D, E, 18 strides, scale, stream
    "fvt_vsa_sparse_bwd_dkv": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 +
    [ctypes.c_longlong] * 18 + [ctypes.c_float, ctypes.c_void_p],
    # q, k, v, o, indices, counts, block_sizes, B, H, Sq, Skv, D, E,
    # n_slots, 12 strides, scale, stream
    "fvt_dyn_sparse_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 +
    [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p],
    # q, k, v, o, indices, counts, block_sizes, B, H, Sq, Skv, D, E, q_rows,
    # n_slots, 12 strides, scale, stream
    "fvt_dyn_sparse_qtile_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 +
    [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p],
    # D: 1 when K9 runs its Hopper schedule; D, nK: its shared memory
    "fvt_dyn_sparse_fwd_sm90_route": [ctypes.c_int],
    "fvt_dyn_sparse_fwd_sm90_smem": [ctypes.c_int] * 2,
    # q, k, v, o, list, counts, bits, order, block_sizes, B, H, Sq, Skv, D,
    # E, group, 12 strides, scale, stream
    "fvt_dyn_sparse_fwd_sm90": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 +
    [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p],
    # the same with q_rows before group
    "fvt_dyn_sparse_qtile_fwd_sm90": [ctypes.c_void_p] * 9 +
    [ctypes.c_int] * 8 + [ctypes.c_longlong] * 12 +
    [ctypes.c_float, ctypes.c_void_p],
    # q, k, v, o, lse (or null), list, counts and bits (or null), order,
    # block_sizes, B, H, S, D, E, group, wgs, list stride, 12 strides,
    # scale, stream
    "fvt_vsa_sparse_padded_fwd_sm90": [ctypes.c_void_p] * 10 +
    [ctypes.c_int] * 8 + [ctypes.c_longlong] * 12 +
    [ctypes.c_float, ctypes.c_void_p],
    # D: 1 when K8 runs its Hopper schedule; D, wgs, list stride: its
    # shared memory
    "fvt_vsa_sparse_padded_fwd_route": [ctypes.c_int],
    "fvt_vsa_sparse_padded_fwd_sm90_smem": [ctypes.c_int] * 3,
    # x (C % 16 == 0), w_hi, w_lo [kt * 3 * C / 16, 3, Co_pad, 16], bias, y,
    # B, T, H, W, C, Co, kt, time_pad, bn, bw, stream
    "fvt_conv3d_tf32": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 +
    [ctypes.c_void_p],
    # Co: the 3xTF32 schedule's N tile; Co, bw: its shared memory
    "fvt_conv3d_tf32_tile_n": [ctypes.c_int],
    "fvt_conv3d_tf32_smem": [ctypes.c_int] * 2,
    # x (C % 32 == 0), w [kt * 3 * C / 32, 3, Co_pad, 32], bias, y, B, T,
    # H, W, C, Co, kt, time_pad, bn, bw, stream
    "fvt_conv3d_sm90": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 +
    [ctypes.c_void_p],
    # dtype, C, Co: K3's schedule (1 the bf16 one, 2 the 3xTF32 one); Co:
    # the bf16 one's N tile;
    # Co, bw: its shared memory
    "fvt_conv3d_route": [ctypes.c_int] * 3,
    "fvt_conv3d_tile_n": [ctypes.c_int],
    "fvt_conv3d_sm90_smem": [ctypes.c_int] * 2,
    # xq, w [kt * 3 * C / 32, 3, Co_pad, 32], scale, bias, y, out dtype, B,
    # T, H, W, C, Co, kt, time_pad, bn, bw, stream
    "fvt_conv3d_int8_sm90": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 +
    [ctypes.c_void_p],
    # Co: K4's N tile; Co, bw: its shared memory
    "fvt_conv3d_int8_tile_n": [ctypes.c_int],
    "fvt_conv3d_int8_sm90_smem": [ctypes.c_int] * 2,
}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel (or source) ``name``, building all
    kernels first."""
    name = SOURCE_OF.get(name, name)
    if name not in SOURCES:
        raise KernelError(f"no kernel or source named {name}")
    with _lock:
        if name not in _libs:
            paths = build_all()
            for n, path in paths.items():
                lib = ctypes.CDLL(path)
                for fn, argtypes in _SIGNATURES.items():
                    if hasattr(lib, fn):
                        getattr(lib, fn).argtypes = argtypes
                        getattr(lib, fn).restype = ctypes.c_int
                _libs[n] = lib
        return _libs[name]


def needs_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd would record a call on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def refuse_grad(name: str, *ts: torch.Tensor, use: str | None = None
                ) -> None:
    """Raise for a kernel with no backward when autograd would need one: its
    output, filled through a ctypes launch, would have no ``grad_fn`` and
    the operands' gradients would be lost without an error. ``use`` names
    the differentiable form of the call, where there is one."""
    if needs_grad(*ts):
        why = (f"the differentiable form is {use}" if use else
               "the JAX package differentiates it on no path")
        raise KernelError(
            f"{name}: the kernel has no backward ({why}); call it under "
            "torch.no_grad() or on detached tensors")


def check_device(t: torch.Tensor, name: str) -> None:
    """Raise unless ``t`` lies on an sm_90 card the kernels were built for."""
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise KernelError(
            f"{name}: the kernel is built for sm_90a (H100/H200); device "
            f"{t.device} has capability {cap}")


def query(name: str, fn: str, *args) -> int:
    """The value of C entry ``fn`` of kernel (or source) ``name``'s library
    (a schedule or size query, not a launch)."""
    return getattr(load(name), fn)(*args)


def launch(name: str, fn: str, *args) -> None:
    """Call C entry ``fn`` of kernel ``name`` and raise on a CUDA error."""
    err = getattr(load(name), fn)(*args)
    if err != 0:
        raise KernelError(f"{name}: launch failed with CUDA error {err}")
    count_launch(name)


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
