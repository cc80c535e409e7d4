"""The frozen reference held to the port's CPU path at a tiny size.

DCANet (num_cva=1) and GwcNet-gc at maxdisp 32 on 32 x 64 pairs, the same
seeded weights loaded into both: the eval forwards, and one KITTI train
step of DCANet (loss, every leaf's gradient through Adam's first moment).
On the CPU both sides run the same float32 operations, so the tolerances
are float32 summation order.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.lib.weights import seeded_state_dict  # noqa: E402
from portbench.reference import stereo  # noqa: E402
from portbench.reference import train as reference_train  # noqa: E402

H, W, MAXDISP = 32, 64, 32
PORT_NAMES = {"dcanet": ("dcanet-cva1", {"num_cva": 1}), "gwcnet-gc": ("gwcnet-gc", {})}


def _pair(arch: str, seed: int = 5):
    from dcanet_tpu_torch.models.registry import make_model

    name, kw = PORT_NAMES[arch]
    ref = stereo.build(arch, maxdisp=MAXDISP, **kw)
    port = make_model(name, maxdisp=MAXDISP)
    sd = seeded_state_dict(ref, seed, "cpu")
    ref.load_state_dict(sd)
    port.load_state_dict(sd, strict=True)
    return ref, port, sd


@pytest.mark.parametrize("arch", sorted(PORT_NAMES))
def test_eval_forward_matches_the_port(arch):
    ref, port, _ = _pair(arch)
    gen = torch.Generator().manual_seed(1)
    left, right = torch.randn(1, 3, H, W, generator=gen), torch.randn(1, 3, H, W, generator=gen)
    ref.eval()
    port.eval()
    with torch.no_grad():
        disp, logits = ref(left, right)
        out = port(left, right)
    torch.testing.assert_close(disp, out.disparity, rtol=0, atol=1e-4)
    assert len(logits) == len(out.class_logits)
    for a, b in zip(logits, out.class_logits):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_kitti_train_step_matches_the_port():
    from dcanet_tpu_torch.train.loop import LossConfig, train_step
    from dcanet_tpu_torch.train.state import create_train_state

    ref, port, sd = _pair("dcanet")
    gen = torch.Generator().manual_seed(2)
    gt = 2.0 + 25.0 * torch.rand(2, H, W, generator=gen)
    gt[torch.rand(2, H, W, generator=gen) < 0.2] = 0.0
    batch = (torch.randn(2, 3, H, W, generator=gen), torch.randn(2, 3, H, W, generator=gen), gt)
    want = reference_train.train_steps(ref, [batch])
    state = create_train_state(port, lambda step: 1e-3, None)
    got = train_step(state, {"left": batch[0], "right": batch[1], "disparity": gt},
                     LossConfig(max_disp=MAXDISP, sparse=True, preset="kitti"))
    assert float(got["total"]) == pytest.approx(want["losses"][0], rel=1e-5)
    median = sorted(want["grad_norms"].values())[len(want["grad_norms"]) // 2]
    for name, p in port.named_parameters():
        g = float(state.optimizer.state[p]["exp_avg"].norm()) / 0.1
        assert abs(g - want["grad_norms"][name]) <= 1e-4 * max(want["grad_norms"][name], median), name
