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

``train_step`` is the one body of an optimizer step: the CPU runs it
eagerly, and on a CUDA device ``train/programs.py`` captures it once as a
CUDA graph and replays it, the counterpart of the JAX trainer's donated
``jax.jit`` step. So nothing in it reads the device from the host or copies
from the host: the global-norm clip is optax's ``clip_by_global_norm``, a
select on the device between g and g / norm * max_norm; the learning rate
is gathered on the device from a table of the schedule (``lr_table``) at
the update count, a device tensor the step advances, into the 0-dim lr
tensor AdamW reads; the noise schedule is a device tensor cached per
device. The optimizer is torch.optim.AdamW with optax's defaults
(``capturable`` on a CUDA device).

With ``lora_rank`` the UNet's attention projections get trainable fp32
factors (``adapters/lora.py``), which join the trainable parameters under
a ``lora.`` prefix (so AdamW, its weight decay, the clip and the EMA take
them as the JAX step's ``trainable["lora"]``). ``loss_fn`` merges them into
the frozen weights before the UNet forward, outside the checkpointed
function, whose argument the merged weights are: as in JAX's
``jax.checkpoint(_unet_fwd)``, they are saved for the backward and the
recompute does not merge again. A batch with ``"context"`` is a
cached-encoder batch (``train/cache.py``): the VAE moments and the towers'
outputs come with it and no tower runs.

Over a mesh (``TrainState.mesh``, ``parallel/mesh.py``) every rank holds
the global batch and its draws, taken from one generator, and computes on
its rows of each microbatch; after the backward and the microbatch
accumulation one flat all-reduce a dtype over the data group makes the
replicated gradients (and the loss) the global batch's mean, before the
clip. So a data-parallel step computes what one device computes on the
global batch.
Parameters FSDP sliced (``parallel/fsdp.py``) get their gradients
reduce-scattered in the backward instead; the global norm then sums each
slice's squares once over the group, and each whole parameter's once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from imagharmony_tpu_torch.adapters import harmony
from imagharmony_tpu_torch.adapters import lora as lora_lib
from imagharmony_tpu_torch.models import clip_text
from imagharmony_tpu_torch.parallel import fsdp
from imagharmony_tpu_torch.parallel import mesh as mesh_lib
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

    def lora_config(self) -> Optional[lora_lib.LoRAConfig]:
        if not self.lora_rank:
            return None
        return lora_lib.LoRAConfig(rank=self.lora_rank, alpha=self.lora_alpha,
                                   targets=tuple(self.lora_targets.split(",")))


def decay_mask(names, unet_cfg) -> Dict[str, bool]:
    """True where AdamW weight decay applies: everywhere except the to_k_ip /
    to_v_ip projections of UNet layers whose IP branch never runs (their
    gradients are exactly zero; decay alone would drift the seeded weights
    toward zero in exported checkpoints)."""
    mask = {}
    for name in names:  # LoRA factors ("lora.*") decay, as JAX's mask gives them
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


def lr_table(cfg: TrainConfig, device=None) -> torch.Tensor:
    """``learning_rate(cfg)`` at the update counts 0..H as fp32 on ``device``,
    H the count from which the schedule stays constant (the warmup's end;
    for cosine the horizon, where it reaches 0): a count past H reads entry
    H, as optax's schedules clamp (``lr_at``)."""
    fn = learning_rate(cfg)
    if cfg.lr_schedule == "cosine":
        horizon = max(cfg.lr_total_steps, cfg.lr_warmup_steps + 1)
    else:
        horizon = max(cfg.lr_warmup_steps, 0)
    return torch.tensor([fn(c) for c in range(horizon + 1)], dtype=torch.float32,
                        device=device)


def lr_at(table: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The lr at update count ``count`` ((1,) int64 on the table's device),
    as a 0-dim fp32 tensor, read on the device."""
    return table.index_select(0, count.clamp(max=table.shape[0] - 1)).view(())


def make_optimizer(trainable: Dict[str, torch.Tensor], cfg: TrainConfig, lr: torch.Tensor):
    """AdamW over ``trainable`` with optax.adamw's b1 0.9, b2 0.999, eps 1e-8;
    the inert IP projections (``decay_mask``) in a group without weight
    decay. Every group reads its lr from ``lr``, a 0-dim fp32 tensor the
    step writes. On a CUDA device it is ``capturable`` (its step count and
    bias corrections stay on the device, as a captured step needs); torch
    refuses that on the CPU."""
    mask = (decay_mask(trainable, cfg.unet_cfg) if cfg.unet_cfg is not None
            else dict.fromkeys(trainable, True))
    groups = [
        {"params": [p for n, p in trainable.items() if mask[n]],
         "weight_decay": cfg.weight_decay},
        {"params": [p for n, p in trainable.items() if not mask[n]], "weight_decay": 0.0},
    ]
    return torch.optim.AdamW([g for g in groups if g["params"]], lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, capturable=lr.device.type == "cuda")


class TrainState:
    """The trainable parameters (live tensors of the model, by name), their
    optimizer, the lr schedule as a device table, the update count (on the
    device, ``count``; its host mirror ``step`` names logs and checkpoints)
    and the optional EMA. With ``lora_rank``, ``factors`` holds the LoRA
    factors by their ``adapters/lora.py`` key (A ~ N(0, 1/r²) from a CPU
    generator seeded with ``seed``, B = 0; fp32 on the model's device), the
    same tensors as the trainable entries ``lora.<key>``; else it is None.
    ``loads`` counts ``load_state_dict`` calls: a load replaces the
    optimizer's state tensors, so a program captured before it is stale.
    ``mesh``: the data-parallel mesh the step reduces over, or None for one
    device."""

    def __init__(self, comps: comp.Components, cfg: TrainConfig, seed=0, mesh=None):
        self.mesh = mesh
        self.trainable = tree_util.set_trainable(comps, cfg.predicate())
        device = next(iter(self.trainable.values())).device
        self.factors = None
        lcfg = cfg.lora_config()
        if lcfg is not None:
            fresh = lora_lib.init_lora(torch.Generator().manual_seed(seed), comps.unet, lcfg)
            self.factors = {k: v.to(device).requires_grad_() for k, v in fresh.items()}
            self.trainable.update({f"lora.{k}": v for k, v in self.factors.items()})
        self.lr_table = lr_table(cfg, device)
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.count = torch.zeros(1, dtype=torch.long, device=device)
        self.optimizer = make_optimizer(self.trainable, cfg, self.lr)
        self.step = 0
        self.loads = 0
        self.ema = ({n: p.detach().clone() for n, p in self.trainable.items()}
                    if cfg.ema_decay else None)

    def state_dict(self):
        """Everything a resume needs, as tensors and plain values; the
        trainable parameters copied to host memory (a copy on the card would
        add their size to a saving trainer's peak)."""
        return {
            "trainable": {n: p.detach().to("cpu", copy=True) for n, p in self.trainable.items()},
            "optimizer": self.optimizer.state_dict(),
            "count": self.count.clone(),
            "lr": self.lr.clone(),
            "step": self.step,
            "ema": self.ema,
        }

    @torch.no_grad()
    def load_state_dict(self, sd):
        for n, p in self.trainable.items():
            p.copy_(sd["trainable"][n])
        self.optimizer.load_state_dict(sd["optimizer"])
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr  # the loaded groups hold a copy of it
        self.lr.copy_(sd["lr"])
        self.count.copy_(sd["count"])
        self.step = int(sd["step"])
        if self.ema is not None:
            for n, e in self.ema.items():
                e.copy_(sd["ema"][n])
        self.loads += 1


def init_state(comps: comp.Components, cfg: TrainConfig, seed=0, mesh=None) -> TrainState:
    """Mark the trainable surface on ``comps`` (and with ``lora_rank`` make
    its factors from ``seed``) and build its optimizer; ``mesh``: see
    ``TrainState``."""
    return TrainState(comps, cfg, seed, mesh)


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
         resolution, out: Optional[Draws] = None) -> Draws:
    """One loss evaluation's draws from ``gen`` (on the device it lives on),
    in the order noise, timesteps, latent_eps, offset; into ``out``'s
    tensors when it is given (a program's static buffers), which gives the
    same values."""
    side = resolution // cfgs.vae.downscale
    shape = (batch_size, side, side, cfgs.vae.latent_channels)
    kw = dict(generator=gen, device=gen.device)
    o = out if out is not None else Draws(None, None, None)
    noise = torch.randn(shape, out=o.noise, **kw)
    timesteps = torch.randint(0, cfg.num_train_timesteps, (batch_size,), out=o.timesteps, **kw)
    latent_eps = torch.randn(shape, out=o.latent_eps, **kw)
    offset = (torch.randn((batch_size, 1, 1, shape[-1]), out=o.offset, **kw)
              if cfg.noise_offset else None)
    return Draws(noise, timesteps, latent_eps, offset)


def _microbatches(rows, cfg: TrainConfig) -> int:
    a = max(cfg.grad_accum, 1)
    if rows % a:
        raise ValueError(f"batch of {rows} rows does not split into {a} microbatches")
    return a


def step_draws(gen: torch.Generator, cfgs: comp.ComponentConfigs, cfg: TrainConfig, rows,
               resolution, out=None):
    """The draws of one optimizer step over ``rows`` rows: one ``Draws`` per
    microbatch, in order (into ``out``'s, when given)."""
    a = _microbatches(rows, cfg)
    return [draw(gen, cfgs, cfg, rows // a, resolution, None if out is None else out[i])
            for i in range(a)]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def loss_fn(comps: comp.Components, cfg: TrainConfig, batch, draws: Draws, factors=None):
    """The training loss of one (micro)batch, fp32 scalar. ``batch``: a dict
    of tensors on the model's device in the ``dummy_batch`` schema, or in
    ``train/cache.py``'s (``"context"`` among its keys). ``factors``: the
    LoRA factors (``TrainState.factors``), merged into the UNet's weights
    for this forward; None for none."""
    cached = "context" in batch
    if cached and comps.cfgs.proj_kind != "image_proj":
        raise ValueError("cached-encoder training supports proj_kind='image_proj' only")
    dt, device = comps.unet.conv_in.weight.dtype, comps.unet.conv_in.weight.device
    acp = sched.alphas_cumprod_on(sched.NoiseScheduleConfig(
        prediction_type=cfg.prediction_type, rescale_betas_zero_snr=cfg.rescale_zero_snr,
    ), device)
    with torch.no_grad():
        if cached:
            # the VAE posterior sampled from the cached moments with the draw
            # the live path gives vae.encode (JAX step.py:204-210)
            mean, logvar = _nchw(batch["latent_mean"]), _nchw(batch["latent_logvar"])
            latents = mean + torch.exp(0.5 * logvar) * _nchw(draws.latent_eps).float()
            latents = (latents * comps.cfgs.vae.scaling_factor).to(dt)
        else:
            # frozen VAE encode, fp32 whatever the weights (reference train.py:628)
            latents = comps.vae.encode(_nchw(batch["images"]),
                                       eps=_nchw(draws.latent_eps)).to(dt)
        noise = draws.noise
        if cfg.noise_offset:
            # channel-wise offset (reference train.py:634-636)
            noise = noise + cfg.noise_offset * draws.offset
        noise = _nchw(noise).to(dt)
        noisy = sched.add_noise(acp, latents, noise, draws.timesteps)
        if cached:
            context, pooled = batch["context"].to(dt), batch["pooled"].to(dt)
            extra_ctx, image_embeds = batch["extra_context"].to(dt), batch["image_embeds"].to(dt)
        else:
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

    # the LoRA merge, outside the checkpointed function: its W' are that
    # function's argument, kept for the backward, not merged again there
    weights = (None if factors is None
               else lora_lib.merged_weights(comps.unet, factors, cfg.lora_config()))

    def unet_fwd(weights_, noisy_, t_, ctx_, pooled_, tids_, ip_):
        kw = dict(pooled_text_embeds=pooled_, time_ids=tids_, ip_tokens=ip_, ip_scale=1.0)
        if weights_ is None:
            return comps.unet(noisy_, t_, ctx_, **kw)
        return torch.func.functional_call(comps.unet, weights_, (noisy_, t_, ctx_), kw)

    args = (weights, noisy, draws.timesteps, context, pooled, time_ids, ip_tokens)
    if cfg.gradient_checkpoint:
        # recompute the UNet's activations in the backward: the frozen base
        # has no parameter gradients, only activation gradients (and, with
        # LoRA, those of the merged weights). The UNet draws no random
        # number, so the recompute is exact without the RNG state that
        # checkpoint would otherwise stash and restore (which a captured
        # step may not read)
        pred = checkpoint(unet_fwd, *args, use_reentrant=False, preserve_rng_state=False)
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
    acp_t = acp[draws.timesteps]
    snr = acp_t / (1.0 - acp_t)
    if cfg.prediction_type == "v_prediction":
        w = torch.clamp(snr, max=cfg.snr_gamma) / (snr + 1.0)
    else:
        w = torch.clamp(cfg.snr_gamma / torch.clamp(snr, min=1e-20), max=1.0)
    return (w * sq.reshape(sq.shape[0], -1).mean(dim=1)).mean()


def _sq_sum(grads, device):
    sq = [g.float().pow(2).sum() for g in grads if g is not None]
    return torch.stack(sq).sum() if sq else torch.zeros((), device=device)


def global_norm(grads, device=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, fp32 (optax.global_norm;
    a parameter without a gradient counts as zeros, and with none at all it
    is a zero on ``device``)."""
    return _sq_sum(grads, device).sqrt()


def sharded_global_norm(params, mesh) -> torch.Tensor:
    """``global_norm`` of the gradients of ``params`` where some are FSDP
    slices: the slices' squares summed over the data group, each whole
    (replicated) gradient's counted once."""
    device = params[0].device
    sliced = _sq_sum([p.grad for p in params if fsdp.info(p) is not None], device)
    torch.distributed.all_reduce(sliced, group=mesh.data_group)
    return (sliced + _sq_sum([p.grad for p in params if fsdp.info(p) is None], device)).sqrt()


@torch.no_grad()
def apply_update(state: TrainState, cfg: TrainConfig) -> torch.Tensor:
    """The clip (optax clip_by_global_norm: g where norm < max_norm, else
    (g / norm) * max_norm, chosen on the device), one AdamW update at the
    lr of the update count, the count advanced, the EMA; returns the
    pre-clip global norm."""
    params = list(state.trainable.values())
    grads = [p.grad for p in params]
    if any(fsdp.info(p) is not None for p in params):
        norm = sharded_global_norm(params, state.mesh)
    else:
        norm = global_norm(grads, params[0].device)
    if cfg.max_grad_norm:
        keep = norm < cfg.max_grad_norm
        for g in grads:
            if g is not None:
                g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * cfg.max_grad_norm))
    state.lr.copy_(lr_at(state.lr_table, state.count))
    state.optimizer.step()
    state.count.add_(1)
    state.step += 1
    if state.ema is not None:
        d = cfg.ema_decay
        for n, p in state.trainable.items():
            e = state.ema[n]
            e.copy_(e * d + p.to(e.dtype) * (1.0 - d))
    return norm


def train_step(state: TrainState, comps: comp.Components, cfg: TrainConfig, batch, draws):
    """One optimizer step over ``batch``: grad_accum microbatches of its
    rows, the i-th with ``draws[i]`` (``step_draws``), the microbatch loop
    unrolled (JAX's lax.scan over them). Returns {"loss", "grad_norm"} as
    fp32 tensors on the device (read them only where the host needs them).
    The gradients are set to None first, so a captured step's backward
    allocates them in its graph's pool and each replay overwrites them.
    Over ``state.mesh``, ``batch`` and ``draws`` are the global batch's:
    this rank takes its rows of each microbatch (``mesh.shard_batch``), and
    the gradients and the loss are reduced over the data group before the
    update."""
    state.optimizer.zero_grad(set_to_none=True)
    rows = next(iter(batch.values())).shape[0]
    a = _microbatches(rows, cfg)
    if len(draws) != a:
        raise ValueError(f"{len(draws)} draws for {a} microbatches")
    loss_sum = None
    for i, d in enumerate(draws):
        mb = {k: v[i * rows // a:(i + 1) * rows // a] for k, v in batch.items()}
        mb = mesh_lib.shard_batch(state.mesh, mb)
        d = Draws(**mesh_lib.shard_batch(state.mesh, vars(d)))
        loss = loss_fn(comps, cfg, mb, d, state.factors)
        loss.backward()
        loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
    if a > 1:
        for p in state.trainable.values():
            if p.grad is not None:
                p.grad.div_(a)
    if state.mesh is not None:
        # a flat all-reduce a dtype: the whole parameters' gradients and the loss
        mesh_lib.reduce_mean(state.mesh, [p.grad for p in state.trainable.values()
                                          if fsdp.info(p) is None] + [loss_sum])
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
