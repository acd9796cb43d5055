"""The port's serving loop held against the JAX package's on the CPU:
the same weights (carried across as numpy) and the same prompts give the
same greedy tokens."""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax

from repro.configs import deepseek_v2_236b as jds
from repro.configs import mixtral_8x22b as jmx
from repro.configs import qwen1_5_0_5b as jqwen
from repro.launch import serve as jserve
from repro.models import transformer as JT

from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.models.weights import lm_from_numpy


def _models(cfg, seed):
    params, _ = JT.init_params(jax.random.PRNGKey(seed), cfg)
    tcfg = TT.LMConfig(**dataclasses.asdict(cfg))
    model = lm_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                          device="cpu")
    return params, tcfg, model


@pytest.mark.parametrize("cfg,B,S,max_new,seed", [
    pytest.param(jqwen._SMOKE, 3, 24, 6, 0, id="3-24-6-0"),
    pytest.param(jqwen._SMOKE, 2, 64, 9, 1, id="2-64-9-1"),
    # the ring cache (window 32) holds a prompt of 45 rolled by (45 - 32)
    # % 32 = 13, and decode overwrites its oldest slots
    pytest.param(jmx._SMOKE, 2, 45, 12, 2, id="mixtral-2-45-12-2"),
    # MLA's latent cache, MoE with a shared expert behind a dense layer
    pytest.param(jds._SMOKE, 2, 30, 8, 3, id="deepseek-2-30-8-3"),
])
def test_serve_greedy_tokens_equal_the_jax_package(cfg, B, S, max_new, seed):
    params, tcfg, model = _models(cfg, seed)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jlog, tlog = [], []
    want = jserve.serve_greedy(cfg, prompts, max_new, params=params,
                               log_fn=jlog.append)
    timings = {}
    got = tserve.serve_greedy(tcfg, prompts, max_new, model=model,
                              device="cpu", log_fn=tlog.append,
                              timings=timings)
    assert got.dtype == np.int32 and got.shape == (B, max_new)
    assert np.array_equal(got, want)
    # The JAX line, with prefill and decode times apart.
    head = jlog[0].split(" in ")[0]
    assert tlog[0].startswith(head) and "prefill" in tlog[0] \
        and "ms/token" in tlog[0]
    assert set(timings) == {"prefill_s", "decode_s", "decode_ms_per_token",
                            "tokens_per_s"}


def test_serve_greedy_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    prompts = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.serve_greedy(TT.LMConfig(**dataclasses.asdict(jqwen._SMOKE)),
                            prompts, 2)


def test_serve_cli_runs_on_cpu(capsys):
    tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                 "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 2 seqs x 3 new tokens" in out and "generated ids" in out
