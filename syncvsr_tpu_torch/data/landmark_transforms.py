"""Landmark augmentation algebra (numpy, CPU-side; port of
``syncvsr_tpu/data/landmark_transforms.py``, an own copy).

Re-implements the reference's composable transform family
(LRW/landmark/src/transform.py:27-338) over [T, 478, 3] mediapipe landmark
clips with NaN marking missing points: probabilistic application (p=),
normalization, temporal crops/pad (-100 sentinel), horizontal/time flips,
linear-interpolated resampling with NaN-mask propagation, coordinate jitter,
global shift/scale/shear, time-interpolated rotations (scipy Rotation),
frame block masking, frame noise, and feature masking. The train/valid recipes
mirror transform.py:315-338.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

try:
    from scipy.spatial.transform import Rotation
except ImportError:  # pragma: no cover
    Rotation = None

Array = np.ndarray


class Transform:
    def __init__(self, p: Optional[float] = None,
                 rng: Optional[np.random.RandomState] = None):
        self.p = p
        self.rng = rng or np.random

    def apply(self, landmarks: Array) -> Array:
        raise NotImplementedError

    def __call__(self, landmarks: Array) -> Array:
        if self.p is None or self.rng.random() < self.p:
            return self.apply(landmarks)
        return landmarks


class Sequential(Transform):
    def __init__(self, *transforms: Transform, **kw):
        super().__init__(**kw)
        self.transforms = transforms

    def apply(self, landmarks: Array) -> Array:
        for t in self.transforms:
            landmarks = t(landmarks)
        return landmarks


class Identity(Transform):
    def apply(self, landmarks: Array) -> Array:
        return landmarks


class LeftCrop(Transform):
    def __init__(self, length: int, **kw):
        super().__init__(**kw)
        self.length = length

    def apply(self, x: Array) -> Array:
        return x[: self.length]


class GroupApply(Transform):
    """Apply per-group transforms over contiguous landmark-index spans
    (transform.py:57-76)."""

    def __init__(self, transforms, lengths, **kw):
        super().__init__(**kw)
        if isinstance(transforms, Transform):
            transforms = [transforms] * len(lengths)
        self.transforms = transforms
        self.lengths = lengths

    def apply(self, x: Array) -> Array:
        outs = []
        offset = 0
        for t, n in zip(self.transforms, self.lengths):
            outs.append(t(x[:, offset:offset + n]))
            offset += n
        return np.concatenate(outs, axis=1)


class Normalize(Transform):
    def __init__(self, max_value: Optional[float] = None, **kw):
        super().__init__(**kw)
        self.max_value = max_value

    def apply(self, x: Array) -> Array:
        scale = self.max_value or np.nan_to_num(x, nan=0.0).std()
        mean = np.nanmean(x.reshape(-1, x.shape[-1]), axis=0)
        return (x - mean) / max(scale, 1e-6)


class CenterCrop(Transform):
    def __init__(self, length: int, **kw):
        super().__init__(**kw)
        self.length = length

    def apply(self, x: Array) -> Array:
        start = max((x.shape[0] - self.length) // 2, 0)
        return x[start:start + self.length]


class RandomCrop(Transform):
    def __init__(self, length: int, **kw):
        super().__init__(**kw)
        self.length = length

    def apply(self, x: Array) -> Array:
        start = self.rng.randint(max(x.shape[0] - self.length, 1))
        return x[start:start + self.length]


class Pad(Transform):
    def __init__(self, length: int, value: float = -100.0, **kw):
        super().__init__(**kw)
        self.length = length
        self.value = value

    def apply(self, x: Array) -> Array:
        pad = self.length - x.shape[0]
        if pad > 0:
            x = np.concatenate(
                [x, np.full((pad,) + x.shape[1:], self.value, x.dtype)])
        return x


class HorizontalFlip(Transform):
    def apply(self, x: Array) -> Array:
        return x * np.asarray([-1.0, 1.0, 1.0], x.dtype)


class TimeFlip(Transform):
    def apply(self, x: Array) -> Array:
        return x[::-1].copy()


class RandomResample(Transform):
    """Temporal linear resample by a random factor; NaN positions forward-fill
    before interpolation and re-mask after (transform.py:163-189)."""

    def __init__(self, limit: Union[float, Tuple[float, float]] = 0.1, **kw):
        super().__init__(**kw)
        self.limit = (1 - limit, 1 + limit) if np.isscalar(limit) else limit

    def apply(self, x: Array) -> Array:
        t = x.shape[0]
        ff = x.copy()
        for i in range(1, t):
            nanmask = np.isnan(ff[i])
            ff[i][nanmask] = ff[i - 1][nanmask]
        valid = (~np.isnan(x)).astype(np.float32)

        scale = self.rng.uniform(*self.limit)
        new_t = max(int(t * scale), 1)
        # linear interp matching F.interpolate(mode="linear", align_corners=False)
        pos = (np.arange(new_t) + 0.5) / scale - 0.5
        lo = np.clip(np.floor(pos).astype(int), 0, t - 1)
        hi = np.clip(lo + 1, 0, t - 1)
        w = np.clip(pos - lo, 0.0, 1.0).astype(np.float32)
        ff0 = np.nan_to_num(ff, nan=0.0)
        out = ff0[lo] * (1 - w)[:, None, None] + ff0[hi] * w[:, None, None]
        vmask = valid[lo] * (1 - w)[:, None, None] + valid[hi] * w[:, None, None]
        out[vmask < 0.5] = np.nan
        return out


class CoordinateJitter(Transform):
    def __init__(self, stdev: float = 0.01, **kw):
        super().__init__(**kw)
        self.stdev = stdev

    def apply(self, x: Array) -> Array:
        return x + self.rng.normal(0, self.stdev, x.shape).astype(x.dtype)


class RandomShift(Transform):
    def __init__(self, stdev: float = 0.1, **kw):
        super().__init__(**kw)
        self.stdev = stdev

    def apply(self, x: Array) -> Array:
        return x + self.rng.normal(0, self.stdev, 3).astype(x.dtype)


class RandomScale(Transform):
    def __init__(self, limit: Union[float, Tuple[float, float]] = 0.1, **kw):
        super().__init__(**kw)
        self.limit = (1 - limit, 1 + limit) if np.isscalar(limit) else limit

    def apply(self, x: Array) -> Array:
        return x * self.rng.uniform(self.limit[0], self.limit[1], 3).astype(x.dtype)


class RandomShear(Transform):
    def __init__(self, limit: float = 0.1, **kw):
        super().__init__(**kw)
        self.limit = limit

    def apply(self, x: Array) -> Array:
        axis = self.rng.choice(3)
        rest = [i for i in range(3) if i != axis]
        s = np.eye(3, dtype=np.float32)
        s[rest, axis] = self.rng.uniform(-self.limit, self.limit, 2)
        return np.einsum("ij,tni->tnj", s, x)


class RandomInterpolatedRotation(Transform):
    def __init__(self, center_stdev: float = 0.5,
                 angle_limit: float = np.pi / 4, **kw):
        super().__init__(**kw)
        self.center_stdev = center_stdev
        self.angle_limit = angle_limit

    def apply(self, x: Array) -> Array:
        t = x.shape[0]
        alpha = np.linspace(0, 1, t, dtype=np.float32)[:, None]
        offset = ((1 - alpha) * self.rng.normal(0, self.center_stdev, 3)
                  + alpha * self.rng.normal(0, self.center_stdev, 3)).astype(np.float32)
        rotvec = ((1 - alpha) * self.rng.uniform(-self.angle_limit, self.angle_limit, 3)
                  + alpha * self.rng.uniform(-self.angle_limit, self.angle_limit, 3))
        rot = Rotation.from_rotvec(rotvec).as_matrix().astype(np.float32)
        centered = x - offset[:, None, :]
        return np.einsum("tij,tni->tnj", rot, centered) + offset[:, None, :]


class FrameBlockMask(Transform):
    def __init__(self, ratio: float = 0.1, block_size: int = 3, **kw):
        super().__init__(**kw)
        self.ratio = ratio
        self.block_size = block_size

    def apply(self, x: Array) -> Array:
        t = x.shape[0]
        n_blocks = max(t // self.block_size, 1)
        hit = self.rng.random(n_blocks) < self.ratio
        mask = np.repeat(hit, self.block_size)[:t]
        if mask.shape[0] < t:
            mask = np.concatenate([mask, np.zeros(t - mask.shape[0], bool)])
        x = x.copy()
        x[mask] = np.nan
        return x


class FrameNoise(Transform):
    def __init__(self, ratio: float = 0.1, noise_stdev: float = 0.3, **kw):
        super().__init__(**kw)
        self.ratio = ratio
        self.noise_stdev = noise_stdev

    def apply(self, x: Array) -> Array:
        t = x.shape[0]
        hit = self.rng.random(t) < self.ratio
        x = x.copy()
        noise = self.rng.normal(0, self.noise_stdev, x.shape).astype(x.dtype)
        x[hit] = noise[hit]
        return x


class FeatureMask(Transform):
    def __init__(self, ratio: float = 0.1, **kw):
        super().__init__(**kw)
        self.ratio = ratio

    def apply(self, x: Array) -> Array:
        hit = self.rng.random(x.shape[1]) < self.ratio
        x = x.copy()
        x[:, hit] = np.nan
        return x


def create_transform(train: bool, max_length: int = 29,
                     rng: Optional[np.random.RandomState] = None) -> Transform:
    """Recipes from transform.py:315-338."""
    kw = {"rng": rng} if rng is not None else {}
    if not train:
        return Sequential(Normalize(**kw), CenterCrop(max_length, **kw),
                          Pad(max_length, **kw), **kw)
    return Sequential(
        Normalize(**kw),
        RandomResample(limit=0.3, p=0.5, **kw),
        RandomCrop(max_length, **kw),
        HorizontalFlip(p=0.5, **kw),
        FrameBlockMask(ratio=0.1, block_size=3, p=0.25, **kw),
        FrameNoise(ratio=0.1, noise_stdev=0.3, p=0.25, **kw),
        FeatureMask(ratio=0.1, p=0.1, **kw),
        RandomInterpolatedRotation(0.2, np.pi / 4, p=0.5, **kw),
        RandomShear(limit=0.2, **kw),
        RandomScale(limit=0.2, **kw),
        RandomShift(stdev=0.1, **kw),
        Pad(max_length, **kw),
        **kw,
    )
