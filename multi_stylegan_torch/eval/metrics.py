"""FID, FVD and IS with the reference evaluation protocol (the JAX package's
eval/metrics.py; reference multi_stylegan/validation_metrics.py).

5,000 real and 5,000 fake samples by default, batch 24; the fakes from the
caller's ``generator_apply(z, z2, generator)`` (the trainer's EMA generator
with fresh noise and no mixing).  FID and IS take one random timestep per
batch and per domain, drawn independently, replicated to 3 RGB channels;
FVD takes the whole 3-frame clip.  Preprocessing order differs by metric:

* FID: per-sample [-1, 1] renormalization (misc.py:216-235, with its
  ``clamp(min=1e-3)`` quirk), then the antialiased bilinear resize to 299;
* IS: resize to 299 first, then renormalize;
* FVD: repeat to RGB, renormalize the clip, resize every frame to 224,
  then NCDHW into I3D.

Features are Inception-v3's 2048-d pool, Inception-v3's class softmax and
I3D's Mixed_5c average; the Frechet distance is scipy's on the host.
Everything else runs under ``torch.no_grad()`` on ``device``, all domains of
a batch in one forward (the JAX metrics' default collection; per-sample
renormalization and running-statistics nets make it equal to one forward
per domain).  The timesteps come from a
``torch.Generator`` per collection, seeded from ``seed``.

Weights: the pretrained torchvision Inception-v3 and pytorch-i3d
``rgb_imagenet`` state dicts are read from the path given, or from the
environment variables the JAX package reads (``MSG_TPU_INCEPTION_PT``,
``MSG_TPU_I3D_PT``).  Without one a metric raises :class:`WeightsUnavailable`
unless ``allow_random_weights=True`` (plumbing and tests only: a score from
random features means nothing).
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from multi_stylegan_torch.eval.frechet import frechet_distance
from multi_stylegan_torch.eval.i3d import InceptionI3D, i3d_from_state_dict
from multi_stylegan_torch.eval.inception_v3 import InceptionV3, inception_from_state_dict
from multi_stylegan_torch.parallel import mesh
from multi_stylegan_torch.utils.image import normalize_m1_1_batch, resize_bilinear_antialias


class WeightsUnavailable(RuntimeError):
    pass


def _load_net(path: Optional[str], env: str, from_state_dict, random_net,
              allow_random_weights: bool, what: str) -> torch.nn.Module:
    path = path or os.environ.get(env)
    if path:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return from_state_dict(sd.get("state_dict", sd))
    if allow_random_weights:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            return random_net().eval()
    raise WeightsUnavailable(f"{what}: pass its path or set {env}")


def frechet_scores(real: Dict[int, np.ndarray], fake: Dict[int, np.ndarray],
                   domains) -> tuple:
    """Each domain's Frechet distance of ``real`` and ``fake``.  Under
    several processes every rank holds the same activations (the global
    batches), so global rank 0 alone takes the host ``sqrtm`` and broadcasts
    the scores, or the error it raised, which every rank raises."""
    result = None
    if mesh.process_index() == 0:
        try:
            result = tuple(frechet_distance(real[d], fake[d]) for d in domains)
        except Exception as e:  # every rank raises it below
            result = e
    result = mesh.broadcast_object(result)
    if isinstance(result, Exception):
        raise result
    return result


class _MetricBase:
    def __init__(self, batch_size: int = 24, data_samples: int = 5000, no_rfp: bool = True,
                 no_gfp: bool = False, latent_dimensions: int = 512, seed: int = 0,
                 device="cuda") -> None:
        self.batch_size = batch_size
        self.data_samples = data_samples
        self.no_rfp, self.no_gfp = no_rfp, no_gfp
        self.latent_dimensions = latent_dimensions
        self.seed = seed
        self.device = torch.device(device)

    @property
    def _domains(self):
        if self.no_gfp:
            return (0,)
        if self.no_rfp:
            return (0, 1)
        return (0, 1, 2)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _fake_batches(self, generator_apply: Callable, gen: torch.Generator) -> Iterable:
        for _ in range(math.ceil(self.data_samples / self.batch_size)):
            z = torch.randn((self.batch_size, self.latent_dimensions), generator=gen,
                            device=self.device)
            yield generator_apply(z, None, gen)

    def draw_timesteps(self, gen: torch.Generator, n_frames: int) -> torch.Tensor:
        """One timestep per domain, independent draws (validation_metrics.py:
        246-256), as a device tensor."""
        return torch.randint(0, n_frames, (len(self._domains),), generator=gen,
                             device=self.device)

    def _frames(self, images: torch.Tensor, timesteps: torch.Tensor) -> List[torch.Tensor]:
        """Per domain, its timestep's frame as [B, 3, H, W]."""
        return [images[:, d].index_select(1, timesteps[j:j + 1]).expand(-1, 3, -1, -1)
                for j, d in enumerate(self._domains)]

    @staticmethod
    def _per_domain(fn, inputs: List[torch.Tensor]) -> List[np.ndarray]:
        """``fn`` of each domain's input, all domains in one forward."""
        return np.split(fn(torch.cat(inputs)).float().cpu().numpy(), len(inputs))

    def _stack(self, acts: Dict[int, list]) -> Dict[int, np.ndarray]:
        return {d: np.concatenate(a)[: self.data_samples] for d, a in acts.items()}

    def _as_batch(self, images) -> torch.Tensor:
        return torch.as_tensor(images).to(self.device, non_blocking=True)


class FID(_MetricBase):
    """Frechet inception distance per imaging domain
    (validation_metrics.py:157-358)."""

    def __init__(self, inception_path: Optional[str] = None, allow_random_weights: bool = False,
                 **kw) -> None:
        super().__init__(**kw)
        self.model = _load_net(inception_path, "MSG_TPU_INCEPTION_PT", inception_from_state_dict,
                               InceptionV3, allow_random_weights,
                               "FID needs torchvision inception_v3 weights").to(self.device)
        self.activations_real: Optional[Dict[int, np.ndarray]] = None

    def features(self, frames: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] raw frames -> [B, 2048]: renormalize, then resize."""
        x = resize_bilinear_antialias(normalize_m1_1_batch(frames), (299, 299))
        return self.model(x, features_only=True)

    @torch.no_grad()
    def _collect(self, batches: Iterable, gen: torch.Generator) -> Dict[int, np.ndarray]:
        acts = {d: [] for d in self._domains}
        count = 0
        for images in batches:
            images = self._as_batch(images)
            frames = self._frames(images, self.draw_timesteps(gen, images.shape[2]))
            for d, f in zip(self._domains, self._per_domain(self.features, frames)):
                acts[d].append(f)
            count += images.shape[0]
            if count >= self.data_samples:
                break
        return self._stack(acts)

    def __call__(self, generator_apply: Callable, dataset, **kwargs):
        if self.activations_real is None:
            self.activations_real = self._collect(iter(dataset), self._generator(self.seed))
        gen = self._generator(self.seed + 1)
        fake = self._collect(self._fake_batches(generator_apply, gen), gen)
        scores = frechet_scores(self.activations_real, fake, self._domains)
        return scores[0] if len(scores) == 1 else scores


class IS(_MetricBase):
    """Inception score per imaging domain (validation_metrics.py:16-154)."""

    def __init__(self, inception_path: Optional[str] = None, allow_random_weights: bool = False,
                 **kw) -> None:
        super().__init__(**kw)
        self.model = _load_net(inception_path, "MSG_TPU_INCEPTION_PT", inception_from_state_dict,
                               InceptionV3, allow_random_weights,
                               "IS needs torchvision inception_v3 weights").to(self.device)

    def probabilities(self, frames: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] raw frames -> [B, 1000] softmax: resize, then renormalize."""
        x = normalize_m1_1_batch(resize_bilinear_antialias(frames, (299, 299)))
        return torch.softmax(self.model(x), dim=1)

    @torch.no_grad()
    def __call__(self, generator_apply: Callable, **kwargs):
        gen = self._generator(self.seed + 2)
        probs = {d: [] for d in self._domains}
        for images in self._fake_batches(generator_apply, gen):
            images = self._as_batch(images)
            frames = self._frames(images, self.draw_timesteps(gen, images.shape[2]))
            for d, p in zip(self._domains, self._per_domain(self.probabilities, frames)):
                probs[d].append(p)
        scores = []
        for p in self._stack(probs).values():
            p_y = p.mean(axis=0, keepdims=True)
            kl = np.sum(p * np.log(p / p_y), axis=-1)
            scores.append(float(np.exp(kl.mean())))
        return scores[0] if len(scores) == 1 else tuple(scores)


class FVD(_MetricBase):
    """Frechet video distance per imaging domain over the whole clip
    (validation_metrics.py:361-568)."""

    def __init__(self, i3d_path: Optional[str] = None, allow_random_weights: bool = False,
                 **kw) -> None:
        super().__init__(**kw)
        self.model = _load_net(i3d_path, "MSG_TPU_I3D_PT", i3d_from_state_dict, InceptionI3D,
                               allow_random_weights,
                               "FVD needs the pytorch-i3d rgb_imagenet weights").to(self.device)
        self.activations_real: Optional[Dict[int, np.ndarray]] = None

    def features(self, clips: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W] one-domain clips -> [B, 1024]: repeat to RGB,
        renormalize, resize every frame to 224 (validation_metrics.py:454-468)."""
        x = normalize_m1_1_batch(clips[:, None].expand(-1, 3, -1, -1, -1))
        b, c, t, h, w = x.shape
        x = resize_bilinear_antialias(x.reshape(b, c * t, h, w), (224, 224))
        return self.model(x.reshape(b, c, t, 224, 224))

    @torch.no_grad()
    def _collect(self, batches: Iterable) -> Dict[int, np.ndarray]:
        acts = {d: [] for d in self._domains}
        count = 0
        for images in batches:
            images = self._as_batch(images)
            clips = [images[:, d] for d in self._domains]
            for d, f in zip(self._domains, self._per_domain(self.features, clips)):
                acts[d].append(f)
            count += images.shape[0]
            if count >= self.data_samples:
                break
        return self._stack(acts)

    def __call__(self, generator_apply: Callable, dataset, **kwargs):
        if self.activations_real is None:
            self.activations_real = self._collect(iter(dataset))
        fake = self._collect(self._fake_batches(generator_apply, self._generator(self.seed + 3)))
        scores = frechet_scores(self.activations_real, fake, self._domains)
        return scores[0] if len(scores) == 1 else scores
