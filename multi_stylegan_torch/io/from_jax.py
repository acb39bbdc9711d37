"""JAX generator pytrees (as numpy arrays) -> the port's reference-keyed state dict.

The port's own copy of the layout transforms of the JAX package's exporter
(io/torch_convert.py::export_generator): every transform is a transpose or
reshape, so weights cross exactly.

* linear ``[in, out]`` -> ``[out, in]``
* modulated conv HWIO ``[kh, kw, Cin, Cout]`` -> ``[1, Cout, Cin, kh, kw]``
  (both the plain and the transposed variant, as the reference stores them)
* constant input ``[1, H, W, C]`` -> ``[1, C, H, W]``; noise ``[1, H, W, 1]``
  -> ``[1, 1, H, W]``; output-block bias ``[1]`` -> ``[1, 1, 1, 1]``
* the blur-kernel buffers are recomputed from the config's taps.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from multi_stylegan_torch.models.config import GeneratorConfig
from multi_stylegan_torch.ops.blur import make_blur_kernel


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _modconv(sd: Dict[str, torch.Tensor], prefix: str, tree: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(tree["weight"]).transpose(3, 2, 0, 1)[None])
    if "modulation" in tree:
        sd[f"{prefix}.modulation_mapping.weight"] = _t(
            np.asarray(tree["modulation"]["weight"]).T)
        sd[f"{prefix}.modulation_mapping.bias"] = _t(tree["modulation"]["bias"])


def generator_state_from_jax(
    params: Mapping[str, Any],
    noises: Mapping[str, Any],
    config: GeneratorConfig = GeneratorConfig(),
) -> Dict[str, torch.Tensor]:
    """JAX ``Generator`` params + noises (numpy leaves) -> the port's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    sm = params["style_mapping"]
    for i in range(config.depth_style_mapping):
        sd[f"style_mapping.layers.{1 + 2 * i}.weight"] = _t(
            np.asarray(sm[f"linear_{i}"]["weight"]).T)
        sd[f"style_mapping.layers.{2 + 2 * i}.bias"] = _t(sm[f"act_{i}"]["bias"])

    def styled(prefix: str, tree: Mapping[str, Any]) -> None:
        _modconv(sd, f"{prefix}.modulated_convolution", tree["conv"])
        sd[f"{prefix}.noise_injection.weight"] = _t(tree["noise"]["weight"])
        sd[f"{prefix}.activation.bias"] = _t(tree["act"]["bias"])

    def output(prefix: str, tree: Mapping[str, Any]) -> None:
        sd[f"{prefix}.bias"] = _t(np.asarray(tree["bias"]).reshape(1, 1, 1, 1))
        _modconv(sd, f"{prefix}.modulated_convolution", tree["conv"])

    blur4 = make_blur_kernel(config.blur_taps, gain=4.0)
    up = make_blur_kernel(config.blur_taps)
    for t in (1, 2):
        sd[f"constant_input_{t}.input"] = _t(
            np.asarray(params[f"constant_input_{t}"]).transpose(0, 3, 1, 2))
        styled(f"starting_convolution_{t}", params[f"starting_convolution_{t}"])
        output(f"starting_output_block_{t}", params[f"starting_output_block_{t}"])
        for i in range(2 * config.n_stages):
            prefix = f"main_convolutions_{t}.{i}"
            styled(prefix, params[f"main_convolutions_{t}_{i}"])
            if i % 2 == 0:  # the k2 upsampling convs carry the gain-4 blur
                sd[f"{prefix}.modulated_convolution.blur.kernel"] = blur4.clone()
        for i in range(config.n_stages):
            output(f"output_blocks_{t}.{i}", params[f"output_blocks_{t}_{i}"])
            sd[f"output_blocks_{t}.{i}.upsampling.kernel"] = up.clone()
    for name, buf in noises.items():
        sd[f"noises.{name}"] = _t(np.asarray(buf).transpose(0, 3, 1, 2))
    return sd
