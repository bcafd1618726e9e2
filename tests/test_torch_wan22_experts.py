"""The Wan2.2 T2V-A14B's two experts through the port against the JAX
package on the CPU in fp32, on a tiny checkpoint with ``transformer_2``:
``from_pretrained`` loads one expert in both packages (WanPipeline's
modules do not name ``transformer_2``), and a pipeline built with
``required_config_modules`` naming it switches experts at the config's
boundary, as JAX's stage does. (JAX's pipeline built that way hands the
second expert to its denoising stage; here the JAX side's loaded stage is
given it, so that its compiled first expert is kept.)

Tolerances: test_torch_wan22_ti2v.py's.
"""

import os
import sys

import torch

import fastvideo_tpu  # noqa: F401  (the JAX reference)

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_wan_i2v import rbg_prng  # noqa: E402
from test_torch_wan22_ti2v import (FP32, GEN, _jax_generator,  # noqa: E402
                                   _same, tiny_checkpoint)

torch.set_num_threads(2)


def test_a14b_experts_match_jax(tmp_path, monkeypatch, jax_plain_attention):
    """``from_pretrained`` loads WanPipeline's modules, which do not name
    ``transformer_2``: one expert runs every step, in JAX and in the port.
    Built with ``required_config_modules`` naming it, the pipeline switches
    to the second expert below the boundary (0.875 of 1000 training
    timesteps) and matches JAX's so built; the request's own
    ``boundary_ratio`` is carried and not read."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    import fastvideo_tpu.parallel as par
    from fastvideo_tpu.models.loader.component_loader import (
        PipelineComponentLoader)
    from fastvideo_tpu.pipelines.basic.wan.wan_pipeline import (
        WanPipeline as JaxWanPipeline)

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.configs.pipelines.wan import (
        Wan2_2_T2V_A14B_Config)
    from fastvideo_tpu_torch.pipelines.basic.wan.wan_pipeline import (
        WanPipeline)

    a14b_ckpt = tiny_checkpoint(str(tmp_path / "Wan2.2-T2V-A14B-tiny"),
                                experts=2)
    kw = dict(GEN, num_inference_steps=3)
    jax_gen = _jax_generator(a14b_ckpt)
    jax_pipe = jax_gen.executor.pipeline
    want_one = jax_gen.generate_video(**kw)
    assert jax_pipe.get_module("transformer_2") is None
    # JAX's pipeline built with transformer_2 hands it to its stage; here
    # the loaded pipeline's stage takes it (its compiled first expert kept)
    modules = JaxWanPipeline._required_config_modules + ["transformer_2"]
    with rbg_prng():
        jax_pipe.denoising_stage.transformer_2 = \
            PipelineComponentLoader.load_module(
                "transformer_2", os.path.join(a14b_ckpt, "transformer_2"),
                jax_pipe.pipeline_config)
    want_two = jax_gen.generate_video(**kw)
    par.destroy_mesh()

    gen = VideoGenerator.from_pretrained(a14b_ckpt, device="cpu", **FP32)
    cfg = gen.fastvideo_args.pipeline_config
    assert type(cfg) is Wan2_2_T2V_A14B_Config and cfg.boundary_ratio == 0.875
    assert "transformer_2" not in gen.pipeline.modules
    got_one = gen.generate_video(**kw, boundary_ratio=0.1)
    _same(got_one, want_one, (1, 4, 3, 16, 24))

    gen.executor.pipeline = WanPipeline(a14b_ckpt, gen.fastvideo_args,
                                        gen.device,
                                        required_config_modules=modules)
    stage = gen.pipeline.denoising_stage
    calls = []
    for name in ("transformer", "transformer_2"):
        gen.pipeline.modules[name].register_forward_hook(
            lambda *_, n=name: calls.append(n))
    got_two = gen.generate_video(**kw)
    _same(got_two, want_two, (1, 4, 3, 16, 24))
    timesteps = [float(t) for t in stage.scheduler.timesteps]
    high = sum(t >= 875 for t in timesteps)
    assert 0 < high < len(timesteps)
    # CFG: two passes a step, by the expert of the step's timestep
    assert calls == (["transformer"] * 2 * high + ["transformer_2"] * 2 *
                     (len(timesteps) - high))
    assert not torch.allclose(got_two["latents"], got_one["latents"])
