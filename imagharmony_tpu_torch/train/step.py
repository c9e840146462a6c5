"""The adapter-training step (port of imagharmony_tpu/train/step.py, the
reference's train.py hot loop).

One step: VAE encode (fp32) -> forward diffusion -> frozen text and image
encoders -> HA fusion -> image projection -> UNet prediction -> MSE, then
AdamW on exactly the trainable parameters. The frozen towers run under
``torch.no_grad()`` (the JAX step's stop_gradient), so the backward touches
the UNet, whose activations carry the adapters' gradients, and nothing else.
Every self-attention downstream of the first live IP branch needs a
gradient and so goes through K1 with its backward, K3.

The JAX step draws its noise, timesteps and VAE posterior sample from a
PRNG key inside the loss. Here ``draw`` takes them from a torch.Generator
and ``loss_fn`` takes them as tensors (``Draws``), so a test can hand the
loss the JAX draws. Tensors at this surface keep the JAX layout: images
(B, H, W, 3), noise and latent draws (B, h, w, 4).

The optimizer is torch.optim.AdamW with optax's defaults and schedules; the
global-norm clip uses optax's formula. LoRA training (``lora_rank``) and
cached-encoder batches are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from imagharmony_tpu_torch.adapters import harmony
from imagharmony_tpu_torch.models import clip_text
from imagharmony_tpu_torch.pipelines import components as comp
from imagharmony_tpu_torch.schedulers import diffusion as sched
from imagharmony_tpu_torch.utils import tree as tree_util


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Defaults mirror the shipped run (reference run.sh:8-20); the fields
    are those of the JAX TrainConfig."""

    learning_rate: float = 2.5e-4
    weight_decay: float = 1e-2
    noise_offset: Optional[float] = None
    num_train_timesteps: int = 1000
    # loss target: "epsilon" | "v_prediction" | "sample"
    prediction_type: str = "epsilon"
    # zero terminal SNR beta rescale (arXiv 2305.08891 §3.1)
    rescale_zero_snr: bool = False
    # Min-SNR loss weighting (arXiv 2303.09556); None = uniform
    snr_gamma: Optional[float] = None
    train_image_proj: bool = False
    max_grad_norm: Optional[float] = None
    gradient_checkpoint: bool = True
    # microbatches per optimizer step
    grad_accum: int = 1
    # EMA of the trainable parameters; None disables
    ema_decay: Optional[float] = None
    lr_warmup_steps: int = 0
    lr_schedule: str = "constant"  # constant | cosine
    lr_total_steps: int = 0  # cosine horizon
    lora_rank: Optional[int] = None
    lora_alpha: Optional[float] = None
    lora_targets: str = "to_q,to_k,to_v,to_out"
    # UNet config that masks weight decay off the inert IP projections;
    # None decays everything
    unet_cfg: Optional[object] = None

    def predicate(self) -> Callable[[str], bool]:
        return (tree_util.adapter_plus_proj_predicate if self.train_image_proj
                else tree_util.adapter_predicate)


def decay_mask(names, unet_cfg) -> Dict[str, bool]:
    """True where AdamW weight decay applies: everywhere except the to_k_ip /
    to_v_ip projections of UNet layers whose IP branch never runs (their
    gradients are exactly zero; decay alone would drift the seeded weights
    toward zero in exported checkpoints)."""
    mask = {}
    for name in names:
        segs = name.split(".")
        if segs[0] == "unet" and ("to_k_ip" in segs or "to_v_ip" in segs):
            mask[name] = unet_cfg.is_ip_active(name)
        else:
            mask[name] = True
    return mask


def learning_rate(cfg: TrainConfig) -> Callable[[int], float]:
    """lr as a function of the number of updates already applied (optax's
    count): constant, linear warmup then constant, or warmup-cosine to 0,
    in optax's closed forms."""
    peak, warmup = cfg.learning_rate, cfg.lr_warmup_steps

    def linear_warmup(count):
        if warmup <= 0:  # optax: a non-positive transition is constant init (0)
            return 0.0
        return peak * min(max(count, 0), warmup) / warmup

    if cfg.lr_schedule == "cosine":
        decay = max(cfg.lr_total_steps, warmup + 1) - warmup

        def cosine(count):
            if count < warmup:
                return linear_warmup(count)
            c = min(count - warmup, decay)
            return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))

        return cosine
    if cfg.lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if warmup:
        return lambda count: linear_warmup(count) if count < warmup else peak
    return lambda count: peak


def make_optimizer(trainable: Dict[str, torch.Tensor], cfg: TrainConfig):
    """(AdamW, LambdaLR) over ``trainable``: optax.adamw's b1 0.9, b2 0.999,
    eps 1e-8; the inert IP projections (``decay_mask``) in a group without
    weight decay. The scheduler's lambda is the absolute lr (base lr 1)."""
    mask = (decay_mask(trainable, cfg.unet_cfg) if cfg.unet_cfg is not None
            else dict.fromkeys(trainable, True))
    groups = [
        {"params": [p for n, p in trainable.items() if mask[n]],
         "weight_decay": cfg.weight_decay},
        {"params": [p for n, p in trainable.items() if not mask[n]], "weight_decay": 0.0},
    ]
    opt = torch.optim.AdamW([g for g in groups if g["params"]], lr=1.0, betas=(0.9, 0.999),
                            eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, learning_rate(cfg))


class TrainState:
    """The trainable parameters (live tensors of the model, by name), their
    optimizer and lr schedule, the update count and the optional EMA."""

    def __init__(self, comps: comp.Components, cfg: TrainConfig):
        if cfg.lora_rank:
            raise NotImplementedError(
                "LoRA training (adapters/lora.py) is not ported yet (ROADMAP A13)")
        self.trainable = tree_util.set_trainable(comps, cfg.predicate())
        self.optimizer, self.scheduler = make_optimizer(self.trainable, cfg)
        self.step = 0
        self.ema = ({n: p.detach().clone() for n, p in self.trainable.items()}
                    if cfg.ema_decay else None)

    def state_dict(self):
        """Everything a resume needs, as tensors and plain values."""
        return {
            "trainable": {n: p.detach().clone() for n, p in self.trainable.items()},
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
            "ema": self.ema,
        }

    @torch.no_grad()
    def load_state_dict(self, sd):
        for n, p in self.trainable.items():
            p.copy_(sd["trainable"][n])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
        self.step = int(sd["step"])
        if self.ema is not None:
            for n, e in self.ema.items():
                e.copy_(sd["ema"][n])


def init_state(comps: comp.Components, cfg: TrainConfig) -> TrainState:
    """Mark the trainable surface on ``comps`` and build its optimizer."""
    return TrainState(comps, cfg)


@dataclasses.dataclass
class Draws:
    """The random numbers of one loss evaluation, JAX layout: ``noise`` and
    ``latent_eps`` (B, h, w, C) N(0, 1) fp32, ``timesteps`` (B,) integers in
    [0, num_train_timesteps), ``offset`` (B, 1, 1, C) N(0, 1) or None."""

    noise: torch.Tensor
    timesteps: torch.Tensor
    latent_eps: torch.Tensor
    offset: Optional[torch.Tensor] = None


def draw(gen: torch.Generator, cfgs: comp.ComponentConfigs, cfg: TrainConfig, batch_size,
         resolution) -> Draws:
    """One loss evaluation's draws from ``gen`` (on the device it lives on)."""
    side = resolution // cfgs.vae.downscale
    shape = (batch_size, side, side, cfgs.vae.latent_channels)
    kw = dict(generator=gen, device=gen.device)
    noise = torch.randn(shape, **kw)
    timesteps = torch.randint(0, cfg.num_train_timesteps, (batch_size,), **kw)
    latent_eps = torch.randn(shape, **kw)
    offset = (torch.randn((batch_size, 1, 1, shape[-1]), **kw) if cfg.noise_offset else None)
    return Draws(noise, timesteps, latent_eps, offset)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def loss_fn(comps: comp.Components, cfg: TrainConfig, batch, draws: Draws):
    """The training loss of one (micro)batch, fp32 scalar. ``batch``: a dict
    of tensors on the model's device in the ``dummy_batch`` schema."""
    if "context" in batch:
        raise NotImplementedError(
            "cached-encoder batches (train/cache.py) are not ported yet (ROADMAP A11)")
    acp = sched.alphas_cumprod(sched.NoiseScheduleConfig(
        prediction_type=cfg.prediction_type, rescale_betas_zero_snr=cfg.rescale_zero_snr,
    ))
    dt = comps.unet.conv_in.weight.dtype
    with torch.no_grad():
        # frozen VAE encode, fp32 whatever the weights (reference train.py:628)
        latents = comps.vae.encode(_nchw(batch["images"]), eps=_nchw(draws.latent_eps)).to(dt)
        noise = draws.noise
        if cfg.noise_offset:
            # channel-wise offset (reference train.py:634-636)
            noise = noise + cfg.noise_offset * draws.offset
        noise = _nchw(noise).to(dt)
        noisy = sched.add_noise(acp, latents, noise, draws.timesteps)
        context, pooled = clip_text.encode_for_sdxl(
            comps.text_encoder, comps.text_encoder_2, batch["ids_l"], batch["ids_g"])
        extra_ctx, _ = clip_text.encode_for_sdxl(
            comps.text_encoder, comps.text_encoder_2, batch["extra_l"], batch["extra_g"])
        image_embeds = comps.image_encoder(batch["clip_pixels"])["projected"]
    # per-sample CFG dropout of the image condition (reference train.py:651-657)
    image_embeds = image_embeds * (1.0 - batch["drop_image"]).to(image_embeds.dtype)[:, None]

    # the trainable surface: HA fusion, projection, decoupled attention
    fused = harmony.fuse_image_embeds(comps.harmony, extra_ctx, image_embeds)
    ip_tokens = comps.image_proj(fused)
    time_ids = torch.cat(
        [batch["original_size"], batch["crop_coords"], batch["target_size"]], dim=-1
    ).float()

    def unet_fwd(noisy_, t_, ctx_, pooled_, tids_, ip_):
        return comps.unet(noisy_, t_, ctx_, pooled_text_embeds=pooled_, time_ids=tids_,
                          ip_tokens=ip_, ip_scale=1.0)

    args = (noisy, draws.timesteps, context, pooled, time_ids, ip_tokens)
    if cfg.gradient_checkpoint:
        # recompute the UNet's activations in the backward: the frozen base
        # has no parameter gradients, only activation gradients
        pred = checkpoint(unet_fwd, *args, use_reentrant=False)
    else:
        pred = unet_fwd(*args)
    if cfg.prediction_type == "v_prediction":
        target = sched.velocity_target(acp, latents, noise, draws.timesteps)
    elif cfg.prediction_type == "sample":
        target = latents
    else:
        target = noise
    sq = (pred.float() - target.float()) ** 2
    if cfg.snr_gamma is None:
        return sq.mean()
    # Min-SNR weighting; epsilon weight min(SNR, g)/SNR as min(1, g/SNR)
    acp_t = torch.as_tensor(acp, dtype=torch.float32, device=sq.device)[draws.timesteps]
    snr = acp_t / (1.0 - acp_t)
    if cfg.prediction_type == "v_prediction":
        w = torch.clamp(snr, max=cfg.snr_gamma) / (snr + 1.0)
    else:
        w = torch.clamp(cfg.snr_gamma / torch.clamp(snr, min=1e-20), max=1.0)
    return (w * sq.reshape(sq.shape[0], -1).mean(dim=1)).mean()


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, fp32 (optax.global_norm;
    a parameter without a gradient counts as zeros)."""
    sq = [g.float().pow(2).sum() for g in grads if g is not None]
    return torch.stack(sq).sum().sqrt() if sq else torch.zeros(())


@torch.no_grad()
def apply_update(state: TrainState, cfg: TrainConfig) -> torch.Tensor:
    """Clip (optax clip_by_global_norm: scale by max_norm / norm only when
    norm > max_norm), one AdamW update with this step's lr, the EMA; returns
    the pre-clip global norm."""
    grads = [p.grad for p in state.trainable.values()]
    norm = global_norm(grads).to(next(iter(state.trainable.values())).device)
    if cfg.max_grad_norm and float(norm) > cfg.max_grad_norm:
        for g in grads:
            if g is not None:
                g.div_(norm.to(g.dtype)).mul_(cfg.max_grad_norm)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    if state.ema is not None:
        d = cfg.ema_decay
        for n, p in state.trainable.items():
            e = state.ema[n]
            e.copy_(e * d + p.to(e.dtype) * (1.0 - d))
    return norm


def train_step(state: TrainState, comps: comp.Components, cfgs: comp.ComponentConfigs,
               cfg: TrainConfig, batch, gen: torch.Generator, resolution):
    """One optimizer step over ``batch`` (grad_accum microbatches of its
    rows, each with its own draws): returns {"loss", "grad_norm"} as fp32
    tensors on the device (read them only where the host needs them)."""
    state.optimizer.zero_grad(set_to_none=True)
    a = max(cfg.grad_accum, 1)
    rows = next(iter(batch.values())).shape[0]
    if rows % a:
        raise ValueError(f"batch of {rows} rows does not split into {a} microbatches")
    loss_sum = None
    for i in range(a):
        mb = {k: v[i * rows // a:(i + 1) * rows // a] for k, v in batch.items()}
        loss = loss_fn(comps, cfg, mb, draw(gen, cfgs, cfg, rows // a, resolution))
        loss.backward()
        loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
    if a > 1:
        for p in state.trainable.values():
            if p.grad is not None:
                p.grad.div_(a)
    grad_norm = apply_update(state, cfg)
    return {"loss": loss_sum / a, "grad_norm": grad_norm}


def dummy_batch(cfgs: comp.ComponentConfigs, batch_size=2, resolution=32, rng=None):
    """Synthetic batch with the real schema (numpy; the JAX dummy_batch's
    values for the same ``rng``)."""
    r = np.random.default_rng(0 if rng is None else rng)
    seq = cfgs.text_l.max_position_embeddings
    return {
        "images": r.normal(size=(batch_size, resolution, resolution, 3)).astype(np.float32) * 0.5,
        "clip_pixels": r.normal(
            size=(batch_size, cfgs.vision.image_size, cfgs.vision.image_size, 3)
        ).astype(np.float32),
        "ids_l": r.integers(0, cfgs.text_l.vocab_size, (batch_size, seq)).astype(np.int32),
        "ids_g": r.integers(0, cfgs.text_g.vocab_size, (batch_size, seq)).astype(np.int32),
        "extra_l": r.integers(0, cfgs.text_l.vocab_size, (batch_size, seq)).astype(np.int32),
        "extra_g": r.integers(0, cfgs.text_g.vocab_size, (batch_size, seq)).astype(np.int32),
        "drop_image": np.zeros((batch_size,), np.float32),
        "original_size": np.full((batch_size, 2), resolution, np.float32),
        "crop_coords": np.zeros((batch_size, 2), np.float32),
        "target_size": np.full((batch_size, 2), resolution, np.float32),
    }


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``: integer ids as int64, the rest
    fp32."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        dtype = torch.long if np.issubdtype(v.dtype, np.integer) else torch.float32
        out[k] = torch.as_tensor(v, dtype=dtype).to(device)
    return out
