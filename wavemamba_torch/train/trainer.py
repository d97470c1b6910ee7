"""Training step and state. The counterpart of `wavemamba_tpu/train/trainer.py`.

  * optimizer: `torch.optim.AdamW(lr, weight_decay, betas)` over all
    parameters, with an optional clip of the gradients' global norm
  * loss: L1 + weighted FFT loss ('l1fft'), or UHDModel's composite ('uhd')
  * LR schedule: a closed-form function of the step (`train/schedules.py`),
    written into the optimizer before every update, step counted from 0
  * EMA: ema = ema * decay + p * (1 - decay), after the update

A model built with `compute_dtype: bfloat16` runs its forward and backward in
bf16 (the model casts its float32 parameters where they are used): the
parameters, their gradients, AdamW's and the EMA's state and the loss stay
float32, as in the JAX trainer.

Where the JAX package threads a pytree through a jitted pure function, the
port keeps a `TrainState` that holds the model, its optimizer and the EMA
copy, and a step that updates them in place.

Data parallel (`mesh` from `parallel.make_mesh()`): one process a card, each
rank's batch its shard of the global batch, the parameters replicated
(`parallel.replicate`). After `backward()` the gradients are averaged over
the mesh in one all_reduce of their concatenation, before the global-norm
clip and AdamW: the gradient of the global batch's mean, which the JAX
step's XLA all-reduce gives. The step runs no `DistributedDataParallel`, so
nothing hooks the backward in which the 'save_scan' recompute hands K1's
outputs back (`ops/scan_cuda.py:save_scan_contexts`).

A model whose scan splits its token axis over the ranks
(`scan_impl='seq_sharded'`, `models.seq_sharded`) needs every rank on the
same rows: the step first gathers the global batch from the ranks' shards,
every rank steps on all of it, and the gradient mean is skipped, since the
scan's backward leaves every rank with the same gradients
(`parallel/seq_scan.py`). That is one step on the global batch, as the JAX
step under `scan_mesh` is. The eval step runs the global batch on every rank
the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from wavemamba_torch.losses import fft_loss, l1_loss, uhd_loss
from wavemamba_torch.models import refuse_training, seq_sharded
from wavemamba_torch.models.wavemamba import wavemamba_forward
from wavemamba_torch.parallel.mesh import gather_rows, mean_, shard_batch
from wavemamba_torch.train.schedules import build_scheduler, with_warmup


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Defaults mirror `options/train_wavemamba_uhdll.yml`."""

    lr: float = 5e-4
    weight_decay: float = 1e-3
    betas: Sequence[float] = (0.9, 0.99)
    scheduler: dict | None = None  # e.g. {'type': 'CosineAnnealingRestartCyclicLR', ...}
    pixel_weight: float = 1.0
    fft_weight: float = 0.1
    ema_decay: float = 0.0  # 0 disables EMA; > 0 enables it
    grad_clip: float | None = None
    warmup_iter: int = -1  # linear LR warm-up; -1 off
    # 'l1fft' = L1 + weighted FFT; 'uhd' = L1 + 0.0004*(1-SSIM) + 0.1*L1 at 1/8
    # [+FFT], which needs a network with two outputs: (out, out8).
    loss_mode: str = "l1fft"


def make_lr(tcfg: TrainConfig):
    """The learning rate: a number, or a function of the step when a
    scheduler or a warm-up is configured."""
    lr = build_scheduler(tcfg.scheduler, tcfg.lr) if tcfg.scheduler else tcfg.lr
    if tcfg.warmup_iter > 0:
        lr = with_warmup(lr, tcfg.warmup_iter)
    return lr


def make_optimizer(params, tcfg: TrainConfig):
    """(AdamW over `params`, lr as `make_lr` gives it)."""
    lr = make_lr(tcfg)
    opt = torch.optim.AdamW(params, lr=lr(0) if callable(lr) else lr, betas=tuple(tcfg.betas),
                            eps=1e-8, weight_decay=tcfg.weight_decay)
    return opt, lr


def clip_by_global_norm(params, max_norm: float):
    """Scale the gradients by max_norm / max(norm, max_norm), norm their
    global L2 norm (optax's rule: exact, no epsilon). Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))
    return norm


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the number of updates taken, and the EMA
    copy of the parameters ({name: tensor}) when EMA is on."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema: dict | None = None

    def state_dict(self) -> dict:
        """{'step', 'params', 'exp_avg', 'exp_avg_sq', 'adam_step', 'ema'}:
        the last four keyed by parameter name; Adam's moments are zero before
        the first update."""
        named = dict(self.model.named_parameters())
        opt = self.optimizer.state
        moment = lambda key: {n: opt[p][key].detach().clone() if p in opt else torch.zeros_like(p)
                              for n, p in named.items()}
        steps = {int(opt[p]["step"]) for p in named.values() if p in opt}
        return {"step": self.step,
                "params": {k: v.detach().clone() for k, v in self.model.state_dict().items()},
                "exp_avg": moment("exp_avg"), "exp_avg_sq": moment("exp_avg_sq"),
                "adam_step": steps.pop() if steps else 0,
                "ema": None if self.ema is None else {k: v.clone() for k, v in self.ema.items()}}

    def load_state_dict(self, sd: dict) -> None:
        """Take over a `state_dict()`, or what `convert.train_state_from_jax`
        makes of a JAX train state."""
        self.model.load_state_dict(sd["params"], strict=True)
        for n, p in self.model.named_parameters():
            self.optimizer.state[p] = {
                "step": torch.tensor(float(sd["adam_step"])),
                "exp_avg": sd["exp_avg"][n].to(p).clone(),
                "exp_avg_sq": sd["exp_avg_sq"][n].to(p).clone()}
        self.step = int(sd["step"])
        if (self.ema is None) != (sd.get("ema") is None):
            raise ValueError("the saved state and the trainer disagree on whether EMA is on")
        if self.ema is not None:
            self.ema = {n: sd["ema"][n].to(p).clone() for n, p in self.model.named_parameters()}


def create_train_state(model, tcfg: TrainConfig) -> TrainState:
    """`model` trains where it lies: move it to the card first
    (`models.init_network` does). A `conv_impl='fused'` model raises."""
    refuse_training(model.cfg)
    opt, _ = make_optimizer(model.parameters(), tcfg)
    ema = None
    if tcfg.ema_decay > 0:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(model=model.train(), optimizer=opt, step=0, ema=ema)


def loss_fn(model, tcfg: TrainConfig, lq, gt):
    """Training loss on NHWC batches; returns (total, metrics dict)."""
    out = wavemamba_forward(model, lq)
    if tcfg.loss_mode == "uhd":
        if not (isinstance(out, (tuple, list)) and len(out) == 2):
            raise TypeError("the UHDModel loss needs a network with two outputs (out, out8); "
                            f"{type(model).__name__} returned one. Use loss_mode='l1fft'.")
        total, metrics = uhd_loss(out[0], out[1], gt, fft_weight=tcfg.fft_weight)
        metrics["total"] = total
        return total, metrics
    if isinstance(out, (tuple, list)):
        out = out[0]
    l_pix = l1_loss(out, gt, loss_weight=tcfg.pixel_weight)
    total = l_pix
    metrics = {"l1": l_pix}
    if tcfg.fft_weight:
        l_fft = fft_loss(out, gt, loss_weight=tcfg.fft_weight)
        total = total + l_fft
        metrics["fft"] = l_fft
    metrics["total"] = total
    return total, metrics


def _to_float(batch):
    """uint8 batches are scaled on the device."""
    return batch.float() / 255.0 if batch.dtype == torch.uint8 else batch


def make_train_step(tcfg: TrainConfig, mesh=None) -> Callable:
    """step(state, lq, gt) -> (state, metrics): one update of `state` in
    place. lq, gt: NHWC batches on the model's device, float32 or uint8:
    with a mesh, this rank's shard of the global batch (the gradients are
    averaged over the mesh, or, for a 'seq_sharded' model, the shards
    gathered: see the module docstring). The metrics are this
    rank's, detached tensors on that device (no host sync here):
    `mean_metrics` averages them over the mesh."""
    lr = make_lr(tcfg)

    def step(state: TrainState, lq, gt):
        whole = mesh is not None and seq_sharded(state.model.cfg)
        if whole:  # every rank on the global batch (the module docstring)
            lq, gt = (gather_rows(mesh, t).flatten(0, 1) for t in (lq, gt))
        lq, gt = _to_float(lq), _to_float(gt)
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(state.model, tcfg, lq, gt)
        total.backward()
        params = list(state.model.parameters())
        if mesh is not None and not whole:
            mean_(mesh, [p.grad for p in params if p.grad is not None])
        if tcfg.grad_clip:
            clip_by_global_norm(params, tcfg.grad_clip)
        for group in state.optimizer.param_groups:
            group["lr"] = lr(state.step) if callable(lr) else lr
        state.optimizer.step()
        state.step += 1
        if state.ema is not None:
            d = tcfg.ema_decay
            ema = list(state.ema.values())
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - d)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def mean_metrics(metrics: dict, mesh=None) -> dict:
    """The step's metrics averaged over the mesh (one all_reduce): the
    global batch's, as the JAX step's replicated metrics are. As they are
    without a mesh. Every rank must call it at the same step."""
    if mesh is None:
        return metrics
    values = [v.detach().float().clone().reshape(1) for v in metrics.values()]
    mean_(mesh, values)
    return {k: v[0] for k, v in zip(metrics, values)}


def make_eval_step(mesh=None) -> Callable:
    """fwd(model, lq) -> the network's output, no gradient; the model's mode
    is restored afterwards. With a mesh, lq is the global batch: each rank
    runs its shard and every rank gets the whole output (the rows gathered
    in rank order; a 'seq_sharded' model runs all of it on every rank), as
    the JAX step's sharded output is one global array."""

    @torch.no_grad()
    def fwd(model, lq):
        whole = mesh is None or seq_sharded(getattr(model, "cfg", None))
        was_training = model.training
        model.eval()
        try:
            out = wavemamba_forward(model, _to_float(lq if whole else shard_batch(mesh, lq)))
        finally:
            model.train(was_training)
        if whole:
            return out
        rows = lambda y: gather_rows(mesh, y).flatten(0, 1)  # noqa: E731
        return type(out)(map(rows, out)) if isinstance(out, (tuple, list)) else rows(out)

    return fwd
