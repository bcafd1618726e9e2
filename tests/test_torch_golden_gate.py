"""The port's golden gate: the port's Wan DiT, FlowUniPC ``step`` and Wan
VAE decoder, loaded with the weights of
``tests/golden/wan_t2v_tiny_golden.npz``, must reproduce the committed
reference output (3 FlowUniPC steps at shift 3, then decode) at PSNR > 35 dB
on the denoised latents and on the frames: the bar and the procedure of
``tests/golden/test_golden_gate.py``, on the CPU in fp32."""

import json
import os

import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu_torch.configs.models.vaes.wan import (
    WAN_VAE_PARAM_NAMES_MAPPING, WanVAEArchConfig)
from fastvideo_tpu_torch.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu_torch.models.loader.weight_utils import load_weights
from fastvideo_tpu_torch.models.schedulers.flow_unipc import (
    FlowUniPCMultistepScheduler)
from fastvideo_tpu_torch.models.vaes.wan import AutoencoderKLWan

torch.set_num_threads(2)

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN = os.path.join(HERE, "wan_t2v_tiny_golden.npz")
FINGERPRINT = os.path.join(HERE, "wan_t2v_tiny_golden.json")


def psnr(a: np.ndarray, b: np.ndarray, peak: float) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64))**2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak**2 / mse)


@pytest.fixture(scope="module")
def golden():
    with open(FINGERPRINT) as fh:
        return np.load(GOLDEN), json.load(fh)


def _arch(cls, cfg):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in cfg.items()})


def _weights(data, prefix):
    # the golden holds the reference's own parameter names, whose patch
    # embedding wraps its conv in ``proj``
    return [(k[len(prefix):].replace("patch_embedding.proj.",
                                     "patch_embedding."),
             torch.from_numpy(data[k]))
            for k in data.files if k.startswith(prefix)]


def test_port_wan_t2v_fixed_seed_psnr_gate(golden, monkeypatch):
    monkeypatch.delenv("FASTVIDEO_ATTENTION_BACKEND", raising=False)
    data, fp = golden
    kw = dict(device="cpu", dtype=torch.float32)
    dit = WanTransformer3DModel(_arch(WanArchConfig, fp["tiny_dit"]),
                                device="meta", dtype=torch.float32)
    vae = AutoencoderKLWan(_arch(WanVAEArchConfig, fp["tiny_vae"]),
                           device="meta", dtype=torch.float32)
    dit_w, vae_w = _weights(data, "dit::"), _weights(data, "vae::")
    assert load_weights(dit, dit_w, **kw) == len(dit_w)
    # the port builds both halves: every tensor of the golden loads
    assert load_weights(vae, vae_w, WAN_VAE_PARAM_NAMES_MAPPING,
                        **kw) == len(vae_w)

    sched = FlowUniPCMultistepScheduler(shift=fp["shift"])
    sched.set_timesteps(fp["num_steps"])
    lat = torch.from_numpy(data["latents0"])
    ctx = torch.from_numpy(data["ctx"])
    with torch.no_grad():
        for t in sched.timesteps:
            pred = dit(lat, ctx, torch.full((1,), float(t)))
            lat = sched.step(pred, t, lat).prev_sample
        golden_lat = data["denoised"]
        lat_psnr = psnr(lat.numpy(), golden_lat,
                        peak=float(np.abs(golden_lat).max()))
        assert lat_psnr > 35.0, f"denoised-latent PSNR {lat_psnr:.1f} <= 35"
        frames = vae.decode(lat).numpy()

    golden_frames = data["frames"]
    assert frames.shape == golden_frames.shape
    p = psnr(frames, golden_frames,
             peak=float(golden_frames.max() - golden_frames.min()))
    assert p > 35.0, f"end-to-end PSNR {p:.2f} dB <= 35 vs the golden"
