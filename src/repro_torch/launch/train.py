"""Training entry point: checkpoint/restart, deterministic data, async
saves (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --smoke --device cpu --steps 20

Picks an arch (``--arch``: any LM arch, dense or MoE, GQA or MLA, full
or sliding-window attention), builds its (possibly reduced) config and
runs AdamW train steps on the synthetic LM stream with:

* checkpoint/restart (``--resume`` restores the latest step; the data is
  regenerated from (seed, step), so a restart replays the exact stream);
* async checkpoint writes in the JAX package's format and layout
  (parameters stacked under ``dense_layers`` and, for MoE stacks,
  ``moe_layers``), so each package restores the other's checkpoints.

One card, no mesh or sharding (as ``launch.serve``): it runs on the
CUDA device unless ``--device cpu``.  The step loop runs inside the
device-purity guard; only log steps and checkpoint saves wait for the
card, each inside ``host_sync``.  Attention is the chunked online
softmax (``layers.chunked_attention``), as in the JAX trainer: the flash
kernel has no backward in either package.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

from repro_torch.configs import get_arch
from repro_torch.core.guards import device_purity_guard, host_sync
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models import weights as W
from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint)
from repro_torch.train.optimizer import OptConfig, opt_init
from repro_torch.train.train_step import make_train_step


def train_lm(cfg: T.LMConfig, *, steps: int = 200, batch: int = 8,
             seq_len: int = 256, lr: float = 3e-3, ckpt_dir: str = "",
             ckpt_every: int = 50, resume: bool = False, seed: int = 0,
             n_microbatches: int = 1, log_every: int = 10, log_fn=print,
             device: DeviceLike = None,
             params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Train an LM config on the synthetic stream.  Returns ``{"history":
    [(step, loss) at each log step], "final": last step's metrics}``.

    ``params`` (a JAX ``init_params`` tree, numpy or tensor leaves) sets
    the initial weights; ``None`` draws seeded ones (``init_params``).
    Every stack trains: dense GQA, sliding windows, MLA and MoE (the
    loss adds ``moe_aux_weight`` times the summed aux loss)."""
    dev = resolve_device(device)
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, batch=batch,
                                    seq_len=seq_len, seed=seed))
    opt_cfg = OptConfig(kind="adamw", lr=lr,
                        warmup_steps=min(50, steps // 10), decay_steps=steps)
    model = (T.init_params(cfg, seed=seed, device=dev, trainable=True)
             if params is None else
             W.lm_from_numpy(cfg, params, dev, trainable=True))
    leaves = W.lm_leaves(model)
    opt = opt_init(leaves, opt_cfg)
    step_fn = make_train_step(
        lambda b: T.loss_fn(model, cfg, b["tokens"], b["labels"]), opt,
        n_microbatches)

    def state():
        return {"params": W.leaves_to_tree(leaves), "opt": opt.state_tree()}

    start_step = 0
    ckpt: Optional[AsyncCheckpointer] = None
    if ckpt_dir:
        ckpt = AsyncCheckpointer(ckpt_dir, keep=3)
        if resume and latest_step(ckpt_dir) is not None:
            restored, start_step, extra = restore_checkpoint(ckpt_dir,
                                                             state())
            W.load_leaves(leaves, restored["params"])
            opt.load_state_tree(restored["opt"])
            log_fn(f"[resume] restored step {start_step} "
                   f"(saved on mesh {extra.get('mesh')})")

    history = []
    t0 = time.time()
    metrics: Dict[str, Any] = {}
    with device_purity_guard():         # on CUDA a host sync here raises
        for step in range(start_step, steps):
            tokens, labels = data.batch(step)
            # _host: pinned, kept alive while its copy is in flight
            _host, (tok, lab) = ops.upload_columns(dev, [tokens.ravel(),
                                                         labels.ravel()])
            metrics = step_fn({"tokens": tok.view(batch, seq_len),
                               "labels": lab.view(batch, seq_len)})
            if (step + 1) % log_every == 0 or step == steps - 1:
                with host_sync("log the step's metrics"):
                    m = {k: float(v) for k, v in metrics.items()}
                history.append((step + 1, m["loss"]))
                rate = (step + 1 - start_step) / (time.time() - t0)
                log_fn(f"step {step+1:5d} loss={m['loss']:.4f} "
                       f"ppl={m.get('ppl', 0):.1f} lr={m['lr']:.2e} "
                       f"gnorm={m['grad_norm']:.2f} ({rate:.2f} it/s)")
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, state(), extra={"mesh": [1, 1]})
    if ckpt:
        ckpt.save(steps, state(), extra={"mesh": [1, 1]})
        ckpt.wait()
    with host_sync("return the final metrics"):
        final = {k: float(v) for k, v in metrics.items()}
    return {"history": history, "final": final}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="override layer count (scaled-down full configs)")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: cuda")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise SystemExit("repro_torch.launch.train drives LM archs; the "
                         "recsys losses (two-tower, SASRec, DIN, xDeepFM) "
                         "train through train.train_step.make_train_step")
    cfg = spec.smoke_config_fn() if args.smoke else spec.config_fn(None)
    over: Dict[str, Any] = {"dtype": "float32", "remat": "none"}
    if args.n_layers:
        over["n_layers"] = args.n_layers
    if args.d_model:
        over["d_model"] = args.d_model
    cfg = dataclasses.replace(cfg, **over)

    out = train_lm(cfg, steps=args.steps, batch=args.batch,
                   seq_len=args.seq_len, lr=args.lr,
                   ckpt_dir=args.ckpt_dir, resume=args.resume,
                   device=args.device)
    print("final:", out["final"])


if __name__ == "__main__":
    main()
