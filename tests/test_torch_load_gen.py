"""The port's load generator (``deepspeed_tpu_torch/tools/load_gen.py``)
against the JAX package's ``tools/load_gen.py`` on the CPU.

Both draw from numpy's generator in the same order, so for one seed the
request lists are byte-identical (JSON text) for every mix, with Poisson
phases or as a burst; the arrival instants are equal; a trace saved by
either package loads in the other, and the CLIs write the same file; and
``drive`` over each package's serving engine (same numpy parameters, the
``SERVE_KW`` geometry) gives the same per-request stamps, states and
tokens in open and closed loop.
"""

import json

import numpy as np
import pytest

from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.tools import load_gen as tlg
from test_torch_chaos import engines  # noqa: F401
from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_serving import SERVE_KW
from tools import load_gen as jlg

PHASES = [(10, 0.8), (5, 2.0), (10, 0.3)]


def test_tables_match_jax():
    assert tlg.MIXES == jlg.MIXES
    assert tlg.SLO_TARGETS == jlg.SLO_TARGETS
    assert tlg.TRACE_VERSION == jlg.TRACE_VERSION


@pytest.mark.parametrize("mix", sorted(jlg.MIXES))
def test_request_lists_byte_identical(mix):
    """Every mix, three seeds, Poisson phases and a burst: the same JSON
    text in both packages."""
    for seed in (0, 1, 7):
        for kw in (dict(phases=PHASES), dict(n=12),
                   dict(phases=PHASES, n=5, max_prompt_len=16)):
            got = tlg.make_requests(seed=seed, mix=mix, vocab_size=128, **kw)
            want = jlg.make_requests(seed=seed, mix=mix, vocab_size=128,
                                     **kw)
            assert json.dumps(got) == json.dumps(want), (seed, kw)
            assert got
    with pytest.raises(ValueError, match="unknown mix"):
        tlg.make_requests(seed=0, mix="nope", n=1)
    with pytest.raises(ValueError, match="need n="):
        tlg.make_requests(seed=0, mix=mix)


def test_poisson_arrivals_match_jax():
    for seed in (0, 3, 11):
        for phases in (PHASES, [(20, 0.0), (20, 2.0), (20, 0.2)],
                       [(50, 0.0)]):
            assert tlg.poisson_arrivals(phases, seed) == \
                jlg.poisson_arrivals(phases, seed)
    ats = tlg.poisson_arrivals([(20, 0.0), (20, 2.0), (20, 0.2)], seed=0)
    assert ats == sorted(ats) and all(20.0 <= t < 60.0 for t in ats)


def test_traces_load_across_packages(tmp_path, capsys):
    """A trace saved by either package loads in the other; the CLIs write
    the same file; a foreign version is refused by both."""
    reqs = tlg.make_requests(seed=4, mix="multitenant", phases=PHASES)
    for save, load in ((tlg, jlg), (jlg, tlg)):
        path = str(tmp_path / f"{save.__name__}.json")
        save.save_trace(path, reqs, seed=4, mix="multitenant")
        assert load.load_trace(path) == reqs
    paths = []
    for mod in (tlg, jlg):
        paths.append(str(tmp_path / f"cli_{mod.__name__}.json"))
        assert mod.main(["--seed", "2", "--mix", "rag", "--phases",
                         "5:1,5:2", "--out", paths[-1]]) == 0
    texts = [open(p).read() for p in paths]
    assert texts[0] == texts[1]
    assert tlg.main(["--seed", "2", "--mix", "chat", "--n", "6"]) == 0
    assert jlg.main(["--seed", "2", "--mix", "chat", "--n", "6"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == out[-2]
    body = json.loads(texts[0])
    body["version"] = 99
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump(body, f)
    for mod in (tlg, jlg):
        with pytest.raises(ValueError, match="trace version"):
            mod.load_trace(bad)


@pytest.mark.parametrize("mode", ["open", "closed"])
def test_drive_matches_jax(engines, mode):
    """``drive`` over a serving engine of each package: the same stamps,
    states, tokens and percentiles, open and closed loop."""
    entries = tlg.make_requests(seed=3, mix="chat", phases=[(8, 1.0)],
                                vocab_size=128)
    got = {}
    for name, smod, lg in (("jax", jserving, jlg), ("port", tserving, tlg)):
        srv = smod.ServingEngine(engines[name], **SERVE_KW)
        got[name] = lg.drive(srv, entries, mode=mode, concurrency=3,
                             slo_ttft=4.0, include_tokens=True)
    assert got["port"] == got["jax"]
    res = got["port"]
    assert res["requests"] == len(entries) > 3
    for rec in res["per_request"]:
        assert rec["state"] == "done"
        assert rec["submitted_at"] <= rec["first_token_at"] \
            <= rec["finished_at"]
        if mode == "open":
            assert rec["submitted_at"] >= rec["arrival"]
    with pytest.raises(ValueError, match="open|closed"):
        tlg.drive(srv, entries, mode="sideways")
    assert np.isfinite(res["ttft_p99"]) and res["slo_attainment"] <= 1.0
