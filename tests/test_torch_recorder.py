"""The port's WorkloadRecorder and obsreport against repro's, on the CPU.

A port run and a repro run of the same request stream through the paged
continuous engine (group prefill, chunked prefill, prefix sharing, decode)
record the same JSONL, record for record, apart from the timestamps; and
each package's ``obsreport --kind workloads|autotune --validate`` accepts
the other's files (the recorder stream and the autotune journal).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import kernels as jkernels  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.autotune import adapters as jadapters  # noqa: E402
from repro.autotune import service as jservice  # noqa: E402
from repro.autotune.log import EventLog as JEventLog  # noqa: E402
from repro.core.cache import ScheduleCache as JScheduleCache  # noqa: E402
from repro.launch import obsreport as jreport  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jnn  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.autotune.adapters import serve_targets  # noqa: E402
from repro_torch.autotune.log import EventLog  # noqa: E402
from repro_torch.autotune.service import (AutotuneConfig,  # noqa: E402
                                          AutotuneService, jsonl_source)
from repro_torch.core.cache import ScheduleCache  # noqa: E402
from repro_torch.launch import obsreport  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

FIELDS = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, head_dim=32, d_ff=128, vocab=128, qk_norm=True,
              dtype="float32")
JCFG = JConfig(**FIELDS).validate()
CFG = ModelConfig(**FIELDS).validate()
SCFG = dict(max_len=48, capacity=3, paged=True, page_size=8, prefill_chunk=8)


def _requests():
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, CFG.vocab, int(rng.integers(3, 28)))
             .astype(np.int32), int(rng.integers(2, 8))) for _ in range(5)]
    p, b = reqs[0]                           # a shared >1-page prefix
    reqs.append((np.concatenate([p[:len(p) - 1], [7, 9, 11]])
                 .astype(np.int32), b))
    return reqs


@pytest.fixture(scope="module")
def mixes(tmp_path_factory):
    """The same stream through each package's paged engine, each streaming
    its recorder to a JSONL: -> (port path, repro path)."""
    d = tmp_path_factory.mktemp("mix")
    jp = jnn.unwrap(JM.init_lm(jax.random.PRNGKey(0), JCFG))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    paths = (str(d / "port.jsonl"), str(d / "repro.jsonl"))
    for path, make in (
            (paths[0], lambda rec: tengine.ContinuousEngine(
                tp, CFG, tengine.ServeConfig(**SCFG), recorder=rec)),
            (paths[1], lambda rec: jengine.ContinuousEngine(
                jp, JCFG, jengine.ServeConfig(**SCFG), recorder=rec))):
        rec = (obs.WorkloadRecorder if path == paths[0]
               else jobs.WorkloadRecorder)(path)
        eng = make(rec)
        for prompt, budget in _requests():
            eng.submit(prompt, budget)
        eng.run(max_steps=1000)
        rec.close()
    return paths


def _records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    for r in recs:
        assert isinstance(r.pop("t"), float)
    return recs


def test_same_stream_records_the_same_jsonl(mixes):
    got, want = (_records(p) for p in mixes)
    assert got == want
    kinds = {r["kind"] for r in got}
    assert kinds == {"submit", "prefill", "decode"}
    # the chunked prefill's records are there (chunk length, batch 1)
    assert any(r["kind"] == "prefill" and r["prompt_len"] == 8
               and r["batch"] == 1 for r in got)
    port = obs.WorkloadRecorder.load(mixes[0]).summary()
    assert port == jobs.WorkloadRecorder.load(mixes[1]).summary()
    assert port["decode_steps"] > 0 and port["submitted"] == 6


@pytest.mark.parametrize("reader", ["port", "repro"])
def test_obsreport_validates_either_recorder_stream(mixes, reader, capsys):
    main = obsreport.main if reader == "port" else jreport.main
    for path in mixes:
        assert main([path, "--kind", "workloads", "--validate"]) == 0
        assert main([path, "--kind", "workloads"]) == 0
    assert ": OK" in capsys.readouterr().out


@pytest.fixture(scope="module")
def journals(mixes, tmp_path_factory):
    """One autotune cycle in each package over the port's recorded stream,
    each journaling to a file: -> (port journal, repro journal)."""
    jkernels.load_all()
    d = tmp_path_factory.mktemp("journal")
    paths = (str(d / "port.autotune.jsonl"), str(d / "repro.autotune.jsonl"))
    with EventLog(paths[0]) as log:
        AutotuneService(
            ScheduleCache(), source=jsonl_source(mixes[0]),
            target_for=serve_targets(CFG, tengine.ServeConfig(**SCFG)),
            config=AutotuneConfig(budget=1, samples=2), log=log,
            device="cpu").run_once()
    with JEventLog(paths[1]) as log:
        jservice.AutotuneService(
            JScheduleCache(), source=jservice.jsonl_source(mixes[0]),
            target_for=jadapters.serve_targets(
                JCFG, jengine.ServeConfig(**SCFG)),
            config=jservice.AutotuneConfig(budget=1, samples=2),
            log=log).run_once()
    return paths


@pytest.mark.parametrize("reader", ["port", "repro"])
def test_obsreport_validates_either_autotune_journal(journals, reader,
                                                     capsys):
    main = obsreport.main if reader == "port" else jreport.main
    for path in journals:
        assert main([path, "--kind", "autotune", "--validate"]) == 0
        assert main([path, "--kind", "autotune"]) == 0
    out = capsys.readouterr().out
    assert "promoted=1" in out and "tuned=1" in out


def test_obsreport_rejects_a_broken_journal(tmp_path, capsys):
    p = tmp_path / "bad.jsonl"
    p.write_text(json.dumps({"kind": "promoted", "t": 1.0}) + "\n")
    assert obsreport.main([str(p), "--kind", "autotune", "--validate"]) == 1
    p.write_text("{torn")
    assert obsreport.main([str(p), "--kind", "autotune", "--validate"]) == 1
    assert "INVALID" in capsys.readouterr().out
