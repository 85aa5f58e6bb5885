"""Training launcher: real steps on one device, checkpoint/restart
(counterpart of ``repro.launch.train``, with its flags plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b --smoke \
      --steps 200 --ckpt-dir /tmp/ckpt --ckpt-every 50 [--device cpu]

With no ``--device`` it runs on the CUDA card, and raises where there is
none.  Fault tolerance: checkpoints are step-atomic; rerunning the same
command resumes from the latest complete checkpoint (data pipeline included:
batches are a pure function of (seed, step)).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, torch_batch_at
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import TrainConfig, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                                         total_steps=args.steps))
    step_fn = make_train_step(cfg, tcfg)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.batch)

    params = registry.init_params(cfg, device=device, seed=0)
    opt_state = adamw_init(params)
    start = 0
    if args.ckpt_dir:
        restored = ckpt.restore_latest(args.ckpt_dir, {"p": params, "o": opt_state})
        if restored:
            start, tree, extra = restored
            params, opt_state = tree["p"], tree["o"]
            print(f"resumed from step {start}")

    extras = {}
    if cfg.family == "vlm":
        extras["patch_embeds"] = torch.zeros((args.batch, cfg.num_patches, cfg.d_model),
                                             dtype=torch.bfloat16, device=device)
    if cfg.family == "encdec":
        extras["enc_embeds"] = torch.zeros((args.batch, cfg.encoder_seq, cfg.d_model),
                                           dtype=torch.bfloat16, device=device)

    t0 = time.time()
    for step in range(start, args.steps):
        batch = torch_batch_at(dc, step, device, extras)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % args.log_every == 0:
            print(f"step {step+1:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time()-t0)/(step-start+1):.2f}s/step)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, {"p": params, "o": opt_state},
                      extra={"arch": args.arch})
    print(f"done: {args.steps - start} steps in {time.time()-t0:.1f}s")
    return params


if __name__ == "__main__":
    main()
