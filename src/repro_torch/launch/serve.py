"""Serving entry point: batched prefill + greedy decode with a KV cache (port
of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --device cpu     # smoke config
    python -m repro_torch.launch.serve --arch mixtral-8x22b --device cpu
    python -m repro_torch.launch.serve --arch deepseek-v2-236b --device cpu

Every LM arch of the registry serves through it: dense GQA, the
sliding-window ring cache and MoE (mixtral), MLA's latent cache with
MoE and shared experts (deepseek-v2); ``--arch`` takes its smoke config.

Runs on the CUDA device unless ``--device cpu``; prefill attention goes
through the Hopper flash-attention kernel there, and the decode loop
runs under the device-purity guard: nothing in it waits for the card.
Serving runs under ``torch.inference_mode()``: it builds no autograd
graph, even with weights that require grad, so the in-place KV-cache
writes never enter one.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.guards import device_purity_guard
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_greedy(cfg: T.LMConfig, prompts: np.ndarray, max_new: int = 16,
                 model: Optional[T.TransformerLM] = None, seed: int = 0,
                 log_fn=print, device: DeviceLike = None,
                 backend: str = "auto",
                 timings: Optional[dict] = None) -> np.ndarray:
    """prompts (B, S) int32 -> generated (B, max_new) int32.

    ``model=None`` draws a seeded model on the device (``device=None``
    means ``cuda``).  ``timings``, when given, receives ``prefill_s``,
    ``decode_s`` (the ``max_new - 1`` decode steps), ``decode_ms_per_token``
    and ``tokens_per_s``, each measured up to a device synchronise.
    ``backend="plain"`` runs prefill attention through the flash kernel's
    plain version on CUDA (``chip_smoke.py`` only)."""
    dev = resolve_device(device)
    if model is None:
        model = T.init_params(cfg, seed=seed, device=dev)
    B, S = prompts.shape
    with torch.inference_mode():
        tokens = torch.as_tensor(np.asarray(prompts, np.int32)).to(dev)
        t0 = time.perf_counter()
        logits, cache = T.prefill(model, cfg, tokens, max_len=S + max_new,
                                  backend=backend)
        tok = logits.argmax(-1).to(torch.int32)
        _sync(dev)
        t1 = time.perf_counter()
        out = [tok]
        with device_purity_guard():     # on CUDA a host sync here raises
            for _ in range(max_new - 1):
                logits, cache = T.decode_step(model, cfg, tok, cache)
                tok = logits.argmax(-1).to(torch.int32)
                out.append(tok)
        gen = torch.stack(out, 1).cpu().numpy()   # waits for the device
    t2 = time.perf_counter()
    dt, n_dec = t2 - t0, max(max_new - 1, 1)
    stats = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
             "decode_ms_per_token": (t2 - t1) / n_dec * 1e3,
             "tokens_per_s": B * max_new / dt}
    if timings is not None:
        timings.update(stats)
    log_fn(f"served {B} seqs x {max_new} new tokens in {dt:.2f}s "
           f"({B * max_new / dt:.1f} tok/s incl. prefill of {S}); prefill "
           f"{stats['prefill_s'] * 1e3:.1f} ms, decode "
           f"{stats['decode_ms_per_token']:.2f} ms/token")
    return gen


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: cuda")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    cfg = spec.smoke_config_fn()
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    gen = serve_greedy(cfg, prompts, args.max_new, device=args.device)
    print("generated ids:\n", gen)


if __name__ == "__main__":
    main()
