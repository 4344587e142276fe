"""Trace capture (``utils/trace.py``, ``DeepSpeedEngine.start_trace``,
``ServingEngine.capture_profile``) against the JAX package on the CPU.

What is held to JAX is the window: which steps fall inside it and the
engine's state after it (steps run, losses, streams and counters), not
the trace's bytes (JAX writes XPlane, the port a Chrome trace). The
port's trace is read back: its ``ds.train_batch`` ranges, and the ranges
that ``instrument`` and ``annotation`` name.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.utils import trace as jtrace
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.utils import trace as ttrace
from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_serving import SERVE_KW, pair  # noqa: F401
from tests.simple_model import (random_batch, simple_model_loss,
                                simple_model_params)


def ranges(path, name):
    """The user-annotation spans called ``name`` in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("name") == name
            and e.get("cat") == "user_annotation"]


def test_instrument_keeps_the_value_and_names_the_range(tmp_path):
    """``instrument`` returns the function's value, as JAX's does under
    jit, and its range (and an ``annotation``'s) is in the capture."""
    @jtrace.instrument("my_op")
    def jf(x):
        return x * 2 + 1

    @ttrace.instrument("my_op")
    def tf(x):
        return x * 2 + 1

    @ttrace.instrument()
    def unnamed(x):
        return x - 1

    want = np.asarray(jax.jit(jf)(np.arange(4.0)))
    with ttrace.capture(str(tmp_path)) as cap:
        got = tf(torch.arange(4.0))
        with ttrace.annotation("outer"):
            unnamed(got)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tf.__name__ == "tf" and os.path.dirname(cap.path) == str(tmp_path)
    for name in ("my_op", "outer", unnamed.__qualname__):
        assert len(ranges(cap.path, name)) == 1, name
    with ttrace.capture(str(tmp_path)) as cap2:
        tf(torch.ones(2))
    assert cap2.path.endswith(".json") and cap2.path != cap.path


def _torch_loss(params, batch, rng=None):
    """``simple_model_loss`` in torch."""
    h, i = batch["x"], 0
    while f"layer_{i}" in params:
        p = params[f"layer_{i}"]
        h = torch.tanh(h @ p["kernel"] + p["bias"])
        i += 1
    pred = (h @ params["head"]["kernel"] + params["head"]["bias"]).squeeze(-1)
    return torch.mean((pred - batch["y"]) ** 2)


CONFIG = {"train_batch_size": 8, "steps_per_print": 1000,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}


def test_start_trace_window_matches_jax(tmp_path):
    """``start_trace(steps=2)``: the next two ``train_batch`` calls are
    inside the window (steps left after each: 1, 0, as in JAX), the
    port's trace holds exactly two ``ds.train_batch`` ranges, later steps
    run untraced, and the losses of all four steps equal JAX's."""
    params = simple_model_params(hidden_dim=16, nlayers=2, seed=0)
    jeng = deepspeed_tpu.initialize(model=simple_model_loss,
                                    model_parameters=params,
                                    config=CONFIG)[0]
    teng = deepspeed_tpu_torch.initialize(
        model=_torch_loss, device="cpu", config=CONFIG,
        model_parameters=jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.asarray(a).copy()), params))[0]
    batch = random_batch(8, 16, seed=0)
    losses, left = {}, {}
    for name, eng in (("jax", jeng), ("port", teng)):
        out = [float(eng.train_batch(batch)["loss"])]
        eng.start_trace(str(tmp_path / name), steps=2)
        for _ in range(3):
            out.append(float(eng.train_batch(batch)["loss"]))
            left.setdefault(name, []).append(eng._trace_steps_left)
        losses[name] = out
    assert left["port"] == left["jax"] == [1, 0, 0]
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    assert glob.glob(str(tmp_path / "jax" / "**" / "*.xplane.pb"),
                     recursive=True)
    written = glob.glob(str(tmp_path / "port" / "*.json"))
    assert written == [teng.last_trace] and teng._trace is None
    assert len(ranges(teng.last_trace, "ds.train_batch")) == 2
    assert teng.global_steps == jeng.global_steps == 4


@pytest.mark.parametrize("pair", ["gpt2"], indirect=True)
def test_capture_profile_window_matches_jax(pair, tmp_path):
    """``capture_profile(steps)`` runs exactly ``steps`` iterations, and
    fewer once the engine is idle, in both packages; the streams and
    counters after each window equal JAX's, and the drain's streams equal
    an untraced drain's. Each call returns ``outdir``."""
    jeng, teng = pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 128, n).astype(np.int32) for n in (9, 5, 12)]
    seen = {}
    for name, mod, eng in (("jax", jserving, jeng), ("port", tserving, teng)):
        srv = mod.ServingEngine(eng, **SERVE_KW)
        reqs = [mod.ServeRequest(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        srv.step()
        windows = []
        for steps in (3, 100):
            out = str(tmp_path / f"{name}{steps}")
            clock = srv._step_clock
            assert srv.capture_profile(steps, out) == out
            windows.append((srv._step_clock - clock, srv.busy,
                            [list(r.out) for r in reqs],
                            srv.stats["decode_steps"]))
        seen[name] = (windows, srv)
    assert seen["port"][0] == seen["jax"][0]
    (run3, busy, _, _), (run_rest, idle, streams, _) = seen["port"][0]
    assert run3 == 3 and busy and run_rest < 100 and not idle
    with open(seen["port"][1].last_trace) as f:
        assert any(e.get("cat") == "cpu_op" for e in json.load(f)[
            "traceEvents"])
    plain = tserving.ServingEngine(teng, **SERVE_KW).run(
        [tserving.ServeRequest(rid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    for i, s in enumerate(streams):
        np.testing.assert_array_equal(s, plain[i][len(prompts[i]):])
