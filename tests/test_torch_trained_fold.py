"""The folded bf16 eval on trained weights, the port against the JAX package,
on the CPU (the JAX package's own check: tests/test_fold_eval.py::
test_eval_dialect_accuracy_on_trained_weights, 0.05 px of EPE drift).

Random weights make a bf16 disparity turn on rounding order, so the fold's
drift is read after training: `dcanet-cva1` at maxdisp 32, float32, trained
with the port's own `train_step` (the SceneFlow loss preset, Adam 1e-3, a
fixed seed) on one synthetic 32x64 pair, a smooth random texture and its
copy shifted by 6 px, until its f32 EPE is below 1 px. The weights go to the
JAX package through `weights.to_jax_variables`. Then, on that pair:
- the port's folded bf16 eval (bf16 autocast) against the JAX package's
  folded bf16 eval (dtype=bfloat16, DCANET_FOLD_EVAL_BN unset): EPE drift
  below 0.05 px;
- each against its own f32 eval: EPE drift below 0.05 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import unflatten_dict

from dcanet_tpu.models import registry as jregistry
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.models import registry
from dcanet_tpu_torch.nn.layers import reference_init_
from dcanet_tpu_torch.train.loop import LossConfig, train_step
from dcanet_tpu_torch.train.state import create_train_state
from test_torch_fold_eval import fold_on  # noqa: F401

torch.set_num_threads(2)

NAME, MAXDISP, H, Wd, GT = "dcanet-cva1", 32, 32, 64, 6
DRIFT = 0.05
MAX_STEPS, CHECK_EVERY, EPE_STOP = 200, 10, 1.0


def shifted_pair(seed):
    """A smooth texture (bilinear 8x along W from noise) and its copy
    shifted left by GT px: the left image's disparity is GT everywhere
    (the last GT columns wrap)."""
    base = torch.from_numpy(np.random.default_rng(seed).standard_normal((1, 3, H, Wd // 8)).astype(np.float32))
    left = torch.nn.functional.interpolate(base, size=(H, Wd), mode="bilinear", align_corners=False)
    return left, torch.roll(left, -GT, dims=3)


def epe(disparity):
    return float(np.abs(np.asarray(disparity, np.float32) - GT).mean())


def test_trained_folded_bf16_eval_drift_matches_jax(fold_on):
    torch.manual_seed(0)
    model = reference_init_(registry.make_model(NAME, maxdisp=MAXDISP), torch.Generator().manual_seed(0))
    state = create_train_state(model, lambda step: 1e-3)
    left, right = shifted_pair(0)
    batch = {"left": left, "right": right, "disparity": torch.full((1, H, Wd), float(GT))}
    cfg = LossConfig(max_disp=MAXDISP, preset="sceneflow")

    def port_disparity(bf16):
        with torch.no_grad(), torch.autocast("cpu", torch.bfloat16, enabled=bf16):
            return model.eval()(left, right).disparity.float().numpy()

    trained = None
    for step in range(1, MAX_STEPS + 1):
        train_step(state, batch, cfg)
        if step % CHECK_EVERY == 0 and epe(port_disparity(False)) < EPE_STOP:
            trained = step
            break
    f32 = port_disparity(False)
    assert trained is not None, f"no EPE below {EPE_STOP} px in {MAX_STEPS} steps: {epe(f32):.4f}"

    flat = unflatten_dict(W.to_jax_variables(model.state_dict(), model), sep="/")
    l_nhwc, r_nhwc = (jnp.asarray(np.moveaxis(t.numpy(), 1, -1)) for t in (left, right))

    def jax_disparity(dtype):
        m = jregistry.make_model(NAME, maxdisp=MAXDISP, dtype=dtype)
        return np.asarray(jax.jit(lambda v, a, b: m.apply(v, a, b, train=False).disparity)(flat, l_nhwc, r_nhwc),
                          np.float32)

    port = {"bf16": port_disparity(True), "f32": f32}
    jx = {"bf16": jax_disparity(jnp.bfloat16), "f32": jax_disparity(None)}
    epes = {f"{side} {d}": epe(v[d]) for side, v in (("port", port), ("JAX", jx)) for d in ("bf16", "f32")}
    drift = {"port bf16 - JAX bf16": abs(epes["port bf16"] - epes["JAX bf16"]),
             "port bf16 - port f32": abs(epes["port bf16"] - epes["port f32"]),
             "JAX bf16 - JAX f32": abs(epes["JAX bf16"] - epes["JAX f32"])}
    print(f"[trained fold] {NAME} maxdisp {MAXDISP}, {trained} train steps; EPE "
          + ", ".join(f"{k} {v:.4f}" for k, v in epes.items()) + " px; EPE drift "
          + ", ".join(f"{k} {v:.4f}" for k, v in drift.items()) + f" px (bound {DRIFT}); mean |port bf16 - JAX "
          f"bf16| {np.abs(port['bf16'] - jx['bf16']).mean():.4f} px, |port f32 - JAX f32| "
          f"{np.abs(port['f32'] - jx['f32']).mean():.2e} px")
    assert np.abs(port["f32"] - jx["f32"]).max() < 5e-3  # the weights carried over
    assert all(v < DRIFT for v in drift.values()), drift
