"""The reference's own checkpoint format, both ways (the JAX package's
io/torch_convert.py: ``convert_reference_checkpoint`` /
``export_reference_checkpoint``, and train/state.py::install_adam_moments).

The reference writes a 6-key ``torch.save`` dict (model_wrapper.py:181-192,
README.md:104-111): ``generator_ema``, ``generator``, ``discriminator``
(its keys behind the ADA wrapper's ``discriminator.`` prefix), both torch
``Adam.state_dict()``s and ``path_length_regularization``.  The port's
state-dict keys and layouts are the reference's, so the models cross as
they are; what needs care is the Adam state, which torch keys by each
parameter's index in the optimizer's group order:

* generator: the 11 groups of the reference ``Generator.get_parameters``
  (multi_stylegan_generator.py:97-112): per tower the constant input, the
  starting conv, the starting output block, the main convs and the output
  blocks, then the style mapping (the lr x 0.01 group); within a module its
  direct parameters come before its children's;
* discriminator: ``Discriminator.parameters()`` registration order.

:class:`~multi_stylegan_torch.train.state.ClippedAdam` keeps its moments in
its own parameter order, so both directions go by parameter name.  Every
imported moment is shape-checked against its parameter, so an order fault
raises instead of grafting the wrong moments.

The format cannot carry the ADA state or the step (the reference resets
them on resume).  ``path_length_regularization`` is written empty, as the
reference's is (its running mean is a plain attribute, loss.py:353-369);
a file whose entry holds ``mean_path_length`` has it read back.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch

from multi_stylegan_torch.models.config import DiscriminatorConfig, GeneratorConfig, TrainingConfig
from multi_stylegan_torch.parallel import tensor as tp
from multi_stylegan_torch.train.state import ClippedAdam, TrainState


def strip_prefixes(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop ``nn.DataParallel``'s ``module.`` and the ADA wrapper's
    ``discriminator.`` key prefixes."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("discriminator."):
            k = k[len("discriminator."):]
        out[k] = v
    return out


def _styled_conv(prefix: str, mapping: bool) -> List[str]:
    names = [f"{prefix}.modulated_convolution.weight"]
    if mapping:
        names += [f"{prefix}.modulated_convolution.modulation_mapping.weight",
                  f"{prefix}.modulated_convolution.modulation_mapping.bias"]
    return names + [f"{prefix}.noise_injection.weight", f"{prefix}.activation.bias"]


def _output_block(prefix: str, mapping: bool) -> List[str]:
    names = [f"{prefix}.bias", f"{prefix}.modulated_convolution.weight"]
    if mapping:
        names += [f"{prefix}.modulated_convolution.modulation_mapping.weight",
                  f"{prefix}.modulated_convolution.modulation_mapping.bias"]
    return names


def generator_adam_groups(config: GeneratorConfig = GeneratorConfig()) -> List[List[str]]:
    """The reference generator optimizer's 11 parameter groups, as ordered
    parameter names: groups 0-9 train at lr, the last (style mapping) at
    lr x lr_style_factor."""
    groups = []
    for t, mapping in ((1, True), (2, False)):
        groups.append([f"constant_input_{t}.input"])
        groups.append(_styled_conv(f"starting_convolution_{t}", mapping))
        groups.append(_output_block(f"starting_output_block_{t}", mapping))
        groups.append([n for i in range(2 * config.n_stages)
                       for n in _styled_conv(f"main_convolutions_{t}.{i}", mapping)])
        groups.append([n for i in range(config.n_stages)
                       for n in _output_block(f"output_blocks_{t}.{i}", mapping)])
    groups.append([n for i in range(config.depth_style_mapping)
                   for n in (f"style_mapping.layers.{1 + 2 * i}.weight",
                             f"style_mapping.layers.{2 + 2 * i}.bias")])
    return groups


def generator_adam_order(config: GeneratorConfig = GeneratorConfig()) -> List[str]:
    """Parameter names at the reference generator optimizer's indices."""
    return [n for group in generator_adam_groups(config) for n in group]


def discriminator_adam_order(model_sd: Mapping[str, Any],
                             config: DiscriminatorConfig = DiscriminatorConfig()) -> List[str]:
    """Parameter names at the reference discriminator optimizer's indices;
    which blocks have a residual mapping is read off ``model_sd`` (prefixes
    stripped)."""

    def residual(prefix):
        name = f"{prefix}.residual_mapping.weight"
        return [name] if name in model_sd else []

    def resnet(prefix):
        return [f"{prefix}.main_mapping.{i}.{kind}"
                for i, kind in enumerate(("weight", "bias", "weight", "bias"))] + residual(prefix)

    def nonlocal_(prefix):  # gamma is the block's own parameter: it comes first
        return ([f"{prefix}.gamma"] + [f"{prefix}.{n}.weight" for n in ("theta", "phi", "g", "o")]
                + residual(prefix))

    names: List[str] = []
    n_enc, n_dec = len(config.encoder_channels), len(config.decoder_channels)
    for i in range(n_enc):
        names += (nonlocal_ if i == 2 else resnet)(f"encoder_blocks.{i}")
    for i in range(n_enc - 1):
        names += [f"downscale_convolutions.{i}.0.weight", f"downscale_convolutions.{i}.0.bias"]
    names += ["classification_head.2.weight", "classification_head.3.bias",
              "classification_head.4.weight"]
    for i in range(n_dec):
        names += (nonlocal_ if i == 1 else resnet)(f"decoder_blocks.{i}")
    names += [f"transposed_convolutions.{i}.1.weight" for i in range(n_dec)]
    return names + ["final_mapping.0.bias", "final_mapping.1.weight"]


# ----------------------------------------------------------------- import


def _step(value) -> int:
    return int(value) if isinstance(value, (int, float)) else int(torch.as_tensor(value).item())


def convert_adam_state(opt_state_dict: Mapping[str, Any], order: Sequence[str],
                       model_sd: Mapping[str, Any]) -> Tuple[Dict[str, torch.Tensor],
                                                             Dict[str, torch.Tensor], int]:
    """A torch ``Adam.state_dict()`` -> (exp_avg by name, exp_avg_sq by
    name, step count).  A parameter the optimizer never stepped has no
    state and gets zero moments, as torch's lazy init."""
    flat = [i for g in opt_state_dict["param_groups"] for i in g["params"]]
    if len(flat) != len(order):
        raise ValueError(f"the optimizer holds {len(flat)} parameters, the architecture "
                         f"{len(order)}: another config?")
    state = opt_state_dict["state"]
    mu, nu, steps = {}, {}, [0]
    for idx, name in zip(flat, order):
        shape = tuple(model_sd[name].shape)
        st = state.get(idx)
        if st is None:
            mu[name] = nu[name] = torch.zeros(shape)
            continue
        if tuple(st["exp_avg"].shape) != shape:
            raise ValueError(f"Adam state {idx} has shape {tuple(st['exp_avg'].shape)}, "
                             f"'{name}' is {shape}: the parameter order does not match")
        mu[name], nu[name] = st["exp_avg"].float(), st["exp_avg_sq"].float()
        steps.append(_step(st.get("step", 0)))
    return mu, nu, max(steps)


@torch.no_grad()
def install_adam_moments(opt: ClippedAdam, module: torch.nn.Module,
                         mu: Mapping[str, torch.Tensor], nu: Mapping[str, torch.Tensor],
                         count: int) -> None:
    """Put moments keyed by parameter name into ``opt`` (whose parameters
    are ``module``'s) and set its step count; the next update continues the
    torch trajectory (the same bias-correction count).  Under tensor
    parallelism a sharded parameter takes this rank's block of its moments."""
    names = {id(p): n for n, p in module.named_parameters()}
    for i, p in enumerate(opt.params):
        name = names[id(p)]
        for moments, src in ((opt.exp_avg, mu), (opt.exp_avg_sq, nu)):
            value = tp.local_block(src[name], p, opt.shard_dims[i])
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"moment of '{name}' has shape {tuple(src[name].shape)}, "
                                 f"the parameter {tuple(p.shape)}")
            moments[i].copy_(value)  # the optimizer's own tensor keeps its identity
    opt.count.fill_(count)


@torch.no_grad()
def import_reference_checkpoint(state: TrainState, ckpt: Mapping[str, Any]) -> List[str]:
    """Load a reference 6-key dict into ``state`` in place: G, G-EMA (noise
    buffers included), D, both Adam states when present and the path-length
    mean when present.  Returns what besides the models it found
    (``"G Adam"``, ``"D Adam"``, ``"path-length mean"``)."""
    g_sd = strip_prefixes(ckpt["generator"])
    d_sd = strip_prefixes(ckpt["discriminator"])
    state.generator.load_state_dict(g_sd, strict=True)
    state.g_ema.load_state_dict(strip_prefixes(ckpt["generator_ema"]), strict=True)
    state.discriminator.load_state_dict(d_sd, strict=True)
    found = []
    for key, label, opt, module, order, full_sd in (
            ("generator_optimizer", "G Adam", state.g_opt, state.generator,
             generator_adam_order(state.generator.config), g_sd),
            ("discriminator_optimizer", "D Adam", state.d_opt, state.discriminator,
             discriminator_adam_order(d_sd, state.discriminator.config), d_sd)):
        if key in ckpt:
            mu, nu, count = convert_adam_state(ckpt[key], order, full_sd)
            install_adam_moments(opt, module, mu, nu, count)
            found.append(label)
    plr = ckpt.get("path_length_regularization") or {}
    if "mean_path_length" in plr:
        state.mean_path_length.fill_(float(torch.as_tensor(plr["mean_path_length"])))
        found.append("path-length mean")
    return found


# ----------------------------------------------------------------- export


def _cpu(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", torch.float32).clone() for k, v in sd.items()}


def _adam_state_dict(opt: ClippedAdam, module: torch.nn.Module, groups: Sequence[Sequence[str]],
                     lrs: Sequence[float], betas: Tuple[float, float]) -> Dict[str, Any]:
    """``opt``'s moments as a torch ``Adam.state_dict()`` (torch 1.8's
    fields, the reference's environment) in the reference's group order."""
    index = {id(p): i for i, p in enumerate(opt.params)}
    params = dict(module.named_parameters())
    count = int(opt.count)
    state, param_groups, idx = {}, [], 0
    for names, lr in zip(groups, lrs):
        ids = []
        for name in names:
            i = index[id(params[name])]
            state[idx] = {"step": count,
                          "exp_avg": opt.exp_avg[i].detach().to("cpu", torch.float32).clone(),
                          "exp_avg_sq": opt.exp_avg_sq[i].detach().to("cpu", torch.float32).clone()}
            ids.append(idx)
            idx += 1
        param_groups.append({"lr": float(lr), "betas": (float(betas[0]), float(betas[1])),
                             "eps": 1e-8, "weight_decay": 0, "amsgrad": False, "params": ids})
    if idx != len(opt.params):
        raise ValueError(f"the reference order names {idx} parameters, the optimizer "
                         f"holds {len(opt.params)}")
    return {"state": state, "param_groups": param_groups}


def export_reference_checkpoint(state: TrainState,
                                cfg: TrainingConfig = TrainingConfig()) -> Dict[str, Any]:
    """``state`` as the reference's 6-key dict, on the host, ready for
    ``torch.save``: what the JAX package's ``export_reference_checkpoint``
    writes for the same state."""
    g, d = state.generator, state.discriminator
    g_groups = generator_adam_groups(g.config)
    g_lrs = [cfg.lr_generator] * (len(g_groups) - 1) + [cfg.lr_generator * cfg.lr_style_factor]
    d_sd = d.state_dict()
    betas = (cfg.adam_beta1, cfg.adam_beta2)
    return {
        "generator_ema": _cpu(state.g_ema.state_dict()),
        "generator": _cpu(g.state_dict()),
        "generator_optimizer": _adam_state_dict(state.g_opt, g, g_groups, g_lrs, betas),
        "discriminator": {f"discriminator.{k}": v for k, v in _cpu(d_sd).items()},
        "discriminator_optimizer": _adam_state_dict(
            state.d_opt, d, [discriminator_adam_order(d_sd, d.config)],
            [cfg.lr_discriminator], betas),
        "path_length_regularization": {},
    }
