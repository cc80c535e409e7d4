"""Dataset catalog: path scanners + a unified StereoDataset (the port's own
copy of dcanet_tpu/data/datasets.py; samples come out channel-first).

Covers the reference's directory walkers (dataloader/datasets.py:50-207 —
SceneFlow Monkaa/FlyingThings/Driving, KITTI 2012/2015, ETH3D, Middlebury
+ additional) and its per-dataset Dataset classes (datasets.py:210-705) with
ONE parameterized class:

  preset        crop      photometric  occl.  sparse  gt
  sceneflow     256x512   no           no     no      PFM
  kitti         256x512   yes (asym)   yes    yes     PNG/256
  eth3d         256x512   yes          yes    no      PFM
  middlebury    320x704   yes          yes    no      PFM (inf -> 0)

Samples are left/right (3, H, W) and disparity (H, W), float32. Test-time
padding is `data/submission.py::pad_to_multiple` (pad-to-16 top/right like
main_dca.py:153-166).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dcanet_tpu_torch.data import augment as A
from dcanet_tpu_torch.data.io import normalize_imagenet, read_disparity, read_image

IMG_EXTS = (".png", ".jpg", ".jpeg", ".ppm", ".bmp", ".webp")


@dataclasses.dataclass(frozen=True)
class StereoSample:
    left: str
    right: str
    disparity: Optional[str] = None


def _is_image(p: str) -> bool:
    return p.lower().endswith(IMG_EXTS)


def scan_sceneflow(root: str) -> Tuple[List[StereoSample], List[StereoSample]]:
    """Monkaa + FlyingThings3D TRAIN/TEST {A,B,C} + Driving, finalpass frames
    with PFM disparities (dataloader/datasets.py:123-207 layout)."""
    train: List[StereoSample] = []
    test: List[StereoSample] = []

    def add(bucket, img_dir, disp_dir):
        left_dir = os.path.join(img_dir, "left")
        if not os.path.isdir(left_dir):
            return
        for im in sorted(os.listdir(left_dir)):
            if not _is_image(im):
                continue
            stem = im.split(".")[0]
            bucket.append(
                StereoSample(
                    left=os.path.join(img_dir, "left", im),
                    right=os.path.join(img_dir, "right", im),
                    disparity=os.path.join(disp_dir, "left", stem + ".pfm"),
                )
            )

    entries = os.listdir(root) if os.path.isdir(root) else []
    frames = [d for d in entries if "frames_finalpass" in d]
    disps = [d for d in entries if "disparity" in d]

    # monkaa: <root>/monkaa_frames_finalpass/<scene>/{left,right}
    for f in frames:
        if "monkaa" in f:
            dsp = next((d for d in disps if "monkaa" in d), None)
            if dsp is None:
                continue
            base, dbase = os.path.join(root, f), os.path.join(root, dsp)
            for scene in sorted(os.listdir(base)):
                add(train, os.path.join(base, scene), os.path.join(dbase, scene))
    # flyingthings: <root>/frames_finalpass/{TRAIN,TEST}/{A,B,C}/<seq>
    if "frames_finalpass" in frames:
        dbase = os.path.join(root, "frames_disparity")
        for split, bucket in (("TRAIN", train), ("TEST", test)):
            for ss in ("A", "B", "C"):
                split_dir = os.path.join(root, "frames_finalpass", split, ss)
                if not os.path.isdir(split_dir):
                    continue
                for seq in sorted(os.listdir(split_dir)):
                    add(
                        bucket,
                        os.path.join(split_dir, seq),
                        os.path.join(dbase, split, ss, seq),
                    )
    # driving: <root>/driving_frames_finalpass/<focal>/<scene>/<speed>
    for f in frames:
        if "driving" in f:
            dsp = next((d for d in disps if "driving" in d), None)
            if dsp is None:
                continue
            base, dbase = os.path.join(root, f), os.path.join(root, dsp)
            for focal in ("35mm_focallength", "15mm_focallength"):
                for scene in ("scene_backwards", "scene_forwards"):
                    for speed in ("fast", "slow"):
                        add(
                            train,
                            os.path.join(base, focal, scene, speed),
                            os.path.join(dbase, focal, scene, speed),
                        )
    return train, test


def scan_kitti2012(root: str) -> List[StereoSample]:
    """colored_0/1 + disp_occ, *_10 frames (dataloader/datasets.py:77-95)."""
    left_dir = os.path.join(root, "colored_0")
    imgs = sorted(i for i in os.listdir(left_dir) if "_10" in i)
    return [
        StereoSample(
            left=os.path.join(root, "colored_0", i),
            right=os.path.join(root, "colored_1", i),
            disparity=os.path.join(root, "disp_occ", i),
        )
        for i in imgs
    ]


def scan_kitti2015(root: str) -> List[StereoSample]:
    """image_2/3 + disp_occ_0, *_10 frames (dataloader/datasets.py:98-119)."""
    left_dir = os.path.join(root, "image_2")
    imgs = sorted(i for i in os.listdir(left_dir) if "_10" in i)
    return [
        StereoSample(
            left=os.path.join(root, "image_2", i),
            right=os.path.join(root, "image_3", i),
            disparity=os.path.join(root, "disp_occ_0", i),
        )
        for i in imgs
    ]


def scan_eth3d(root: str) -> List[StereoSample]:
    """<root>/<scene>/{im0.png, im1.png, disp0GT.pfm}
    (dataloader/datasets.py:50-57)."""
    samples = []
    for scene_dir in sorted(glob.glob(os.path.join(root, "*"))):
        if not os.path.isdir(scene_dir):
            continue
        disp = os.path.join(scene_dir, "disp0GT.pfm")
        samples.append(
            StereoSample(
                left=os.path.join(scene_dir, "im0.png"),
                right=os.path.join(scene_dir, "im1.png"),
                disparity=disp if os.path.exists(disp) else None,
            )
        )
    return samples


def scan_middlebury(root: str, additional: bool = False) -> List[StereoSample]:
    """<root>/<scene>/{im0.png, im1.png, disp0GT.pfm|disp0.pfm}
    (dataloader/datasets.py:59-75)."""
    disp_name = "disp0.pfm" if additional else "disp0GT.pfm"
    samples = []
    for scene_dir in sorted(glob.glob(os.path.join(root, "*"))):
        if not os.path.isdir(scene_dir):
            continue
        disp = os.path.join(scene_dir, disp_name)
        samples.append(
            StereoSample(
                left=os.path.join(scene_dir, "im0.png"),
                right=os.path.join(scene_dir, "im1.png"),
                disparity=disp if os.path.exists(disp) else None,
            )
        )
    return samples


PRESETS: Dict[str, Dict] = {
    "sceneflow": dict(crop=(256, 512), photometric=False, occlusion=False, sparse=False),
    "kitti": dict(crop=(256, 512), photometric=True, occlusion=True, sparse=True),
    "eth3d": dict(crop=(256, 512), photometric=True, occlusion=True, sparse=False),
    "middlebury": dict(crop=(320, 704), photometric=True, occlusion=True, sparse=False),
}


class StereoDataset:
    """Decodes one sample to normalized numpy arrays.

    Training: photometric jitter (if preset) -> random crop -> right-image
    occlusion (if preset) -> ImageNet normalize -> channel-first.
    Test: full images (use submission.pad_to_multiple for static shapes).
    `half_res=True` resizes images and gt by 0.5 (Middlebury additional,
    dataloader/datasets.py:547-688).
    """

    def __init__(
        self,
        samples: Sequence[StereoSample],
        training: bool,
        preset: str = "sceneflow",
        half_res: bool = False,
        seed: int = 0,
    ):
        assert preset in PRESETS, preset
        self.samples = list(samples)
        self.training = training
        self.preset = preset
        self.cfg = PRESETS[preset]
        self.half_res = half_res
        self.seed = seed

    def __len__(self):
        return len(self.samples)

    def reseed(self, seed: int):
        self.seed = seed

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        # Per-sample generator derived from (epoch seed, index): augmentation
        # is deterministic regardless of decode-thread scheduling. (A single
        # shared Generator raced across the loader's thread pool, making
        # augmented batches — and training — non-reproducible.)
        rng = np.random.default_rng((self.seed, index))
        s = self.samples[index]
        left = read_image(s.left)
        right = read_image(s.right)
        disp = (
            read_disparity(s.disparity)
            if s.disparity is not None
            else np.zeros(left.shape[:2], np.float32)
        )

        if self.half_res:
            left = _half(left)
            right = _half(right)
            disp = _half(disp) * 0.5

        if self.training:
            if self.cfg["photometric"]:
                left, right = A.photometric_pair(left, right, rng)
            left, right, disp = A.random_crop(
                left, right, disp, self.cfg["crop"], rng
            )
            if self.cfg["occlusion"]:
                right = A.occlusion_patch(right, rng)

        return {
            "left": _chw(normalize_imagenet(left)),
            "right": _chw(normalize_imagenet(right)),
            "disparity": disp.astype(np.float32),
        }


def _chw(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img.transpose(2, 0, 1), np.float32)


def _half(x: np.ndarray) -> np.ndarray:
    """Area-style 2x downsample (matches cv2.resize INTER_AREA closely for
    even shapes)."""
    h, w = x.shape[:2]
    h2, w2 = h // 2 * 2, w // 2 * 2
    x = x[:h2, :w2]
    if x.ndim == 3:
        return x.reshape(h2 // 2, 2, w2 // 2, 2, -1).mean(axis=(1, 3))
    return x.reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3))
