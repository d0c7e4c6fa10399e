"""The train launcher, the counterpart of the JAX package's
``launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --smoke --steps 30 --ckpt-dir <dir> [--device cuda]

One card (``--device``, default ``cuda``; ``cpu`` runs the plain
versions of the kernels). ``--smoke`` scales the config down. Wired here,
as in the reference: gradient accumulation, checkpoint/resume,
failure injection for restart drills, the straggler watchdog, and int8
error-feedback gradient compression. ``--production-mesh`` (the
reference's 16x16 TPU mesh) raises: TPU meshes are left to the TPU
(README.md, "Left to the TPU").
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs import get
from ..data.tokens import synthetic_lm_batches
from ..device import resolve_device
from ..models import transformer as tf
from ..optim import AdamW, cosine_schedule
from ..train import compression
from ..train.trainer import Trainer, TrainerConfig


def build_step_and_state(cfg, *, lr=3e-4, warmup=100, total=10_000,
                         num_microbatches=1, compress_grads=False,
                         seed=0, device=None, state_dtype="float32"):
    """(step, state) for ``Trainer``: random bfloat16 parameters drawn from
    a ``torch.Generator`` seeded with ``seed`` on ``device``, AdamW
    (moments in ``state_dtype``) under the reference's cosine schedule,
    and ``make_train_step``'s step. With ``compress_grads`` the state
    keeps the reference's shape ``(model, ((model, opt_state), ef))``:
    the gradients go through int8 error-feedback quantization before the
    update (one microbatch, as the reference's compressed step)."""
    dev = resolve_device(device)
    opt = AdamW(lr=cosine_schedule(lr, warmup, total),
                state_dtype=state_dtype)
    model = tf.init_lm(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(seed), device=dev)
    opt_state = opt.init(model)
    if not compress_grads:
        return tf.make_train_step(cfg, opt,
                                  num_microbatches=num_microbatches), \
            (model, opt_state)

    def step_with_compression(model, opt_state, batch):
        (model_o, opt_o), ef = opt_state
        model = model_o if model is None else model
        names, params = zip(*model.named_parameters())
        with model.trainable():
            loss, _ = tf.lm_loss(model, batch["tokens"], batch["labels"],
                                 remat=True)
            grads = dict(zip(names, torch.autograd.grad(loss, params)))
        grads, ef = compression.compressed_gradients(grads, ef)
        model, new_opt, gnorm = opt.update(grads, opt_o, model)
        return model, ((model, new_opt), ef), {"loss": loss.detach(),
                                               "gnorm": gnorm}

    ef = compression.init_ef_state(dict(model.named_parameters()))
    return step_with_compression, (model, ((model, opt_state), ef))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's 16x16 TPU mesh (not ported)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro-train-ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (restart drill)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: the reference's TPU mesh is left to the TPU "
            "(README.md, 'Left to the TPU'; ROADMAP A11.5); the port trains "
            "on one card")

    cfg = get(args.arch)
    if args.smoke:
        cfg = cfg.scaled()
    dev = resolve_device(args.device)
    step, state = build_step_and_state(
        cfg, lr=args.lr, total=args.steps * 10,
        num_microbatches=args.microbatches,
        compress_grads=args.compress_grads, device=dev)
    data = synthetic_lm_batches(cfg.vocab, args.global_batch, args.seq_len,
                                device=dev)

    def failure_hook(step_idx):
        if args.fail_at is not None and step_idx == args.fail_at:
            raise RuntimeError(f"injected failure at step {step_idx}")

    trainer = Trainer(
        TrainerConfig(total_steps=args.steps,
                      checkpoint_every=args.checkpoint_every,
                      ckpt_dir=args.ckpt_dir),
        step, state, data,
        failure_hook=failure_hook if args.fail_at else None)
    if args.resume and trainer.try_resume():
        trainer.data = synthetic_lm_batches(
            cfg.vocab, args.global_batch, args.seq_len, device=dev,
            start_step=trainer.step)
    report = trainer.run()
    losses = [m["loss"] for m in report["history"] if "loss" in m]
    print(f"done: step={report['final_step']} "
          f"first_loss={losses[0]:.4f} last_loss={losses[-1]:.4f} "
          f"stragglers={len(report['stragglers'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
