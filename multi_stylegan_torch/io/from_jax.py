"""JAX model pytrees (as numpy arrays) -> the port's reference-keyed state dicts.

The port's own copy of the layout transforms of the JAX package's exporter
(io/torch_convert.py::export_generator / export_discriminator): every
transform is a transpose or reshape, so weights cross exactly.

* linear ``[in, out]`` -> ``[out, in]``; conv HWIO -> OIHW
* modulated conv HWIO ``[kh, kw, Cin, Cout]`` -> ``[1, Cout, Cin, kh, kw]``
  (both the plain and the transposed variant, as the reference stores them)
* constant input ``[1, H, W, C]`` -> ``[1, C, H, W]``; noise ``[1, H, W, 1]``
  -> ``[1, 1, H, W]``; output-block bias ``[1]`` -> ``[1, 1, 1, 1]``;
  NonLocal ``gamma`` stays 0-d
* the blur-kernel buffers are recomputed from the config's taps.

``train_state_from_jax`` carries a whole JAX ``TrainState`` (given as numpy
trees) into the port's: parameters, noise buffers, EMA, both optimizers'
Adam moments and step count, the ADA state and the mean path length.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from multi_stylegan_torch.models.config import DiscriminatorConfig, GeneratorConfig
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


def _conv(a) -> torch.Tensor:
    return _t(np.asarray(a).transpose(3, 2, 0, 1))


def discriminator_state_from_jax(
    params: Mapping[str, Any], config: DiscriminatorConfig = DiscriminatorConfig()
) -> Dict[str, torch.Tensor]:
    """JAX ``Discriminator`` params (numpy leaves) -> the port's state dict."""
    sd: Dict[str, torch.Tensor] = {}

    def block(prefix: str, tree: Mapping[str, Any]) -> None:
        if "gamma" in tree:  # NonLocalBlock
            sd[f"{prefix}.gamma"] = _t(np.asarray(tree["gamma"]).reshape(()))
            for name in ("theta", "phi", "g", "o"):
                sd[f"{prefix}.{name}.weight"] = _conv(tree[name]["weight"])
        else:
            for i, name in enumerate(("conv_0", "act_0", "conv_1", "act_1")):
                if name.startswith("conv"):
                    sd[f"{prefix}.main_mapping.{i}.weight"] = _conv(tree[name]["weight"])
                else:
                    sd[f"{prefix}.main_mapping.{i}.bias"] = _t(tree[name]["bias"])
        if "residual" in tree:
            sd[f"{prefix}.residual_mapping.weight"] = _conv(tree["residual"]["weight"])

    kernel = make_blur_kernel()
    n_enc = len(config.encoder_channels)
    for i in range(n_enc):
        block(f"encoder_blocks.{i}", params[f"encoder_{i}"])
    for i in range(n_enc - 1):
        sd[f"downscale_convolutions.{i}.0.weight"] = _conv(params[f"downscale_{i}"]["weight"])
        sd[f"downscale_convolutions.{i}.0.bias"] = _t(params[f"downscale_{i}"]["bias"])
        sd[f"downscale_convolutions.{i}.1.kernel"] = kernel.clone()
    sd["classification_head.2.weight"] = _t(np.asarray(params["head_linear_0"]["weight"]).T)
    sd["classification_head.3.bias"] = _t(params["head_act"]["bias"])
    sd["classification_head.4.weight"] = _t(np.asarray(params["head_linear_1"]["weight"]).T)
    for i in range(len(config.decoder_channels)):
        block(f"decoder_blocks.{i}", params[f"decoder_{i}"])
        sd[f"transposed_convolutions.{i}.0.kernel"] = kernel.clone()
        sd[f"transposed_convolutions.{i}.1.weight"] = _conv(params[f"upconv_{i}"]["weight"])
    sd["final_mapping.0.bias"] = _t(params["final_act"]["bias"])
    sd["final_mapping.1.weight"] = _conv(params["final_conv"]["weight"])
    return sd


def _adam_moments(opt_state) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """(mu, nu, count) of a JAX optimizer state, read without optax: every
    node with ``mu``/``nu``/``count`` fields is an Adam state, and the masked
    groups of a multi-transform overlay into one parameter-shaped tree (the
    masked-out leaves are empty tuples)."""
    mu: Dict[str, Any] = {}
    nu: Dict[str, Any] = {}
    counts = [0]

    def overlay(dst, src):
        for k, v in src.items():
            if isinstance(v, Mapping):
                overlay(dst.setdefault(k, {}), v)
            elif isinstance(v, np.ndarray):
                dst[k] = v

    def visit(node):
        if all(hasattr(node, f) for f in ("mu", "nu", "count")):
            counts.append(int(np.asarray(node.count)))
            overlay(mu, node.mu)
            overlay(nu, node.nu)
        elif isinstance(node, Mapping):
            for v in node.values():
                visit(v)
        elif isinstance(node, tuple):
            for v in node:
                visit(v)
        elif hasattr(node, "inner_state"):
            visit(node.inner_state)

    visit(opt_state)
    return mu, nu, max(counts)


def _notfinite_count(opt_state) -> int:
    return int(np.asarray(getattr(opt_state, "notfinite_count", 0)))


def _load_optimizer(opt, module, mu_sd, nu_sd, count: int, notfinite: int) -> None:
    names = {id(p): n for n, p in module.named_parameters()}
    for i, p in enumerate(opt.params):
        name = names[id(p)]
        # into the optimizer's own tensors: the fused step's tables point there
        opt.exp_avg[i].copy_(mu_sd[name].reshape(p.shape))
        opt.exp_avg_sq[i].copy_(nu_sd[name].reshape(p.shape))
    opt.count.fill_(count)
    opt.notfinite_count.fill_(notfinite)


def train_state_from_jax(state, g_config: GeneratorConfig, d_config: DiscriminatorConfig,
                         train_config):
    """A JAX ``TrainState`` whose leaves are numpy arrays (``jax.tree.map(
    np.asarray, state)``, the PRNG key left out or None) -> the port's
    ``TrainState`` on ``device``: parameters, noise buffers, EMA, both
    optimizers' Adam moments, step counts and skip counters, the ADA state,
    the mean path length and the step, on the CPU (``.to`` the models and
    optimizer tensors from there)."""
    from multi_stylegan_torch.models.discriminator import Discriminator
    from multi_stylegan_torch.models.generator import Generator
    from multi_stylegan_torch.train.ada import AdaState
    from multi_stylegan_torch.train.state import create_train_state

    noises = state.g_noises
    generator = Generator(g_config)
    generator.load_state_dict(generator_state_from_jax(state.g_params, noises, g_config))
    discriminator = Discriminator(d_config)
    discriminator.load_state_dict(discriminator_state_from_jax(state.d_params, d_config))
    out = create_train_state(generator, discriminator, train_config)
    out.step = int(np.asarray(state.step))
    out.g_ema.load_state_dict(generator_state_from_jax(state.g_ema_params, noises, g_config))
    for opt, module, opt_state, to_sd in (
            (out.g_opt, out.generator, state.g_opt_state,
             lambda t: generator_state_from_jax(t, noises, g_config)),
            (out.d_opt, out.discriminator, state.d_opt_state,
             lambda t: discriminator_state_from_jax(t, d_config))):
        mu, nu, count = _adam_moments(opt_state)
        _load_optimizer(opt, module, to_sd(mu), to_sd(nu), count, _notfinite_count(opt_state))
    ada = state.ada
    out.ada = AdaState(
        p=torch.tensor(float(np.asarray(ada.p))),
        r_sum=torch.tensor(float(np.asarray(ada.r_sum))),
        r_count=torch.tensor(int(np.asarray(ada.r_count)), dtype=torch.int32),
        last_r=torch.tensor(float(np.asarray(ada.last_r))))
    out.mean_path_length = torch.tensor(float(np.asarray(state.mean_path_length)))
    return out
