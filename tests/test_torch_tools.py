"""The port's serving forensics tools (`accelerate_tpu_torch.tools`) against
the reference's (`tools/*.py`), on files the port wrote.

A port engine (tiny GPT-2 on the CPU, paged, with the prefix cache, the
host-RAM KV tier, a tracer, a telemetry JSONL and a journal) serves a few
requests, one of them hibernated and woken mid-decode, and leaves its trace
export, telemetry time-series and request journal in a temporary directory.
Each port tool (``python -m accelerate_tpu_torch.tools.<name>``, and its
``main`` in-process) and the reference's tool (run as a subprocess with
``JAX_PLATFORMS=cpu``) read the same file: the same exit code and the same
JSON report, or the same text once wall-clock fields are masked. Then the
reference's exit contracts from ``tests/test_tools_cli.py`` on the port's
tools (malformed spans, anomalous and non-journal files, the alerts line,
the single-vs-merged `explain_request`, journal and telemetry context), and
``check_metrics_docs`` clean on the port's surface against the reference's
unchanged ``docs/observability.md``.
"""

import contextlib
import importlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from accelerate_tpu_torch.serving import (
    FINISH_LENGTH,
    KVTierConfig,
    PagedKVConfig,
    PrefixCacheConfig,
    Request,
    RequestJournal,
    SamplingParams,
    ServingEngine,
    TelemetryConfig,
    TelemetryExporter,
    Tracer,
)
from accelerate_tpu_torch.serving.trace import EV_QUEUED, EV_SUBMIT
from torch_threads import one_torch_thread  # noqa: F401

_REPO = Path(__file__).resolve().parent.parent
TOOLS = ("journal_fsck", "trace_report", "explain_request", "serve_top", "check_metrics_docs")


def _port_cmd(name: str, *args) -> dict:
    """``python -m accelerate_tpu_torch.tools.<name>`` from the repo root."""
    return dict(args=[sys.executable, "-m", f"accelerate_tpu_torch.tools.{name}",
                      *map(str, args)], cwd=_REPO, env={**os.environ, "PYTHONPATH": str(_REPO)})


def _ref_cmd(name: str, *args) -> dict:
    """The reference's ``tools/<name>.py`` on the CPU."""
    return dict(args=[sys.executable, str(_REPO / "tools" / f"{name}.py"), *map(str, args)],
                env={**os.environ, "JAX_PLATFORMS": "cpu"})


def _run_all(cmds: dict[str, dict]) -> dict[str, subprocess.CompletedProcess]:
    """Run every command at once (each is interpreter and import start-up
    bound) and collect them by key."""
    procs = {key: subprocess.Popen(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                   **cmd) for key, cmd in cmds.items()}
    out = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=180)
        out[key] = subprocess.CompletedProcess(proc.args, proc.returncode, stdout, stderr)
    return out


def _inproc(name: str, *args) -> tuple[int, str]:
    mod = importlib.import_module(f"accelerate_tpu_torch.tools.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main([str(a) for a in args])
    return rc, out.getvalue()


def _masked(text: str) -> str:
    """serve_top's wall-clock fields (the point's age against now) masked."""
    return re.sub(r"\d+(\.\d+)?s ago", "<age> ago", text)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One port engine's trace export, telemetry JSONL and journal, with a
    hibernate -> wake mid-decode, so the host-tier gauges are live."""
    tmp = tmp_path_factory.mktemp("served")
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    tracer = Tracer()
    telemetry = TelemetryExporter(TelemetryConfig(interval_s=0.0,
                                                  jsonl_path=str(tmp / "telemetry.jsonl")))
    engine = ServingEngine(model, device="cpu", max_concurrency=3, prompt_buckets=(16, 64),
                           paged_kv=PagedKVConfig(block_tokens=16, num_blocks=24),
                           prefix_cache=PrefixCacheConfig(block_tokens=16),
                           kv_tier=KVTierConfig(wake_policy="upload"), tracer=tracer,
                           telemetry=telemetry, journal=str(tmp / "requests.journal"))
    r = np.random.default_rng(3)
    prefix = r.integers(0, 256, 20).tolist()
    for i in range(5):
        prompt = prefix + r.integers(0, 256, 3 + i).tolist()
        assert engine.submit(Request(prompt=prompt, params=SamplingParams(
            max_new_tokens=8, temperature=0.8 if i % 2 else 0.0, seed=i))).accepted
    parked = False
    while engine.has_work:
        engine.step()
        ready = [int(s) for s in np.flatnonzero(engine._active)
                 if len(engine._slot_out[int(s)].tokens) >= 2]
        if ready and not parked:
            engine.kv_tier.hibernate_slot(ready[0])
            parked = True
    assert parked and engine.metrics.host_wakeups.value == 1
    tracer.export(tmp / "trace.json")
    telemetry.close()
    engine.journal.close()
    return tmp


@pytest.fixture(scope="module")
def runs(served):
    """Each tool of both packages over the served files, all run at once:
    ``(tool, package, case)`` -> the finished process."""
    trace, journal, tele = (served / "trace.json", served / "requests.journal",
                            served / "telemetry.jsonl")
    cases = {
        ("journal_fsck", "file"): (journal,),
        ("journal_fsck", "all"): ("--all", served),
        ("trace_report", "json"): (trace, "--slo", "--json"),
        ("trace_report", "text"): (trace, "--slo"),
        ("explain_request", "0"): ("0", trace, "--journal", journal, "--telemetry", tele,
                                   "--json"),
        ("explain_request", "1"): ("1", trace, "--journal", journal, "--telemetry", tele,
                                   "--json"),
        ("explain_request", "text"): ("0", trace),
        ("serve_top", "file"): (tele,),
        ("check_metrics_docs", "json"): ("--json",),
    }
    cmds = {}
    for (tool, case), args in cases.items():
        cmds[(tool, "jax", case)] = _ref_cmd(tool, *args)
        if case in ("file", "json"):  # one module run of each port tool
            cmds[(tool, "torch", case)] = _port_cmd(tool, *args)
    return cases, _run_all(cmds)


def _pair(runs, tool, case):
    """The port's (return code, stdout) and the reference's process."""
    cases, done = runs
    got = done.get((tool, "torch", case))
    got = (got.returncode, got.stdout) if got is not None else _inproc(tool, *cases[tool, case])
    return got, done[(tool, "jax", case)]


# ------------------------------------------------------ port against reference
@pytest.mark.parametrize("case", ["file", "all"])
def test_journal_fsck_equals_the_reference(runs, case):
    (rc, out), want = _pair(runs, "journal_fsck", case)
    assert rc == want.returncode == 0, want.stderr
    assert json.loads(out) == json.loads(want.stdout)
    if case == "file":
        assert json.loads(out)["finished"] == 5


@pytest.mark.parametrize("case", ["json", "text"])
def test_trace_report_equals_the_reference(runs, case):
    (rc, out), want = _pair(runs, "trace_report", case)
    assert rc == want.returncode == 0, out + want.stderr
    if case == "json":
        rep = json.loads(out)
        assert rep == json.loads(want.stdout)
        assert rep["clean"] and rep["requests"] == 5
    else:
        assert out == want.stdout and "malformed_spans=0" in out


@pytest.mark.parametrize("case", ["0", "1", "text"])
def test_explain_request_equals_the_reference(runs, case):
    """The woken request 0 (its trace carries the wake's ADMIT) and request
    1, with the journal and telemetry as context, and the text report."""
    (rc, out), want = _pair(runs, "explain_request", case)
    assert rc == want.returncode == 0, out + want.stderr
    if case == "text":
        assert out == want.stdout and "queue_wait" in out
        return
    rep = json.loads(out)
    assert rep == json.loads(want.stdout)
    assert rep["journal"]["finished"] and rep["telemetry"]["points"] > 0


def test_serve_top_equals_the_reference_with_the_host_tier_line(runs, served):
    (rc, out), want = _pair(runs, "serve_top", "file")
    assert rc == want.returncode == 0, want.stderr
    assert _masked(out) == _masked(want.stdout)
    assert "\nhost   [ok" in out and "0 hibernated" in out
    last = json.loads((served / "telemetry.jsonl").read_text().splitlines()[-1])
    assert last["serving/mem/host_tier/page_ins"] > 0
    assert last["serving/mem/host_tier/page_outs"] > 0


def test_check_metrics_docs_clean_on_the_port_surface(runs):
    (rc, out), want = _pair(runs, "check_metrics_docs", "json")
    assert rc == 0, out
    rep = json.loads(out)
    assert rep["clean"] and not rep["missing_metrics"] and not rep["missing_kinds"]
    assert rep["families"] > 50 and rep["kinds"] >= 14
    assert rep["kinds"] == json.loads(want.stdout)["kinds"]


# ------------------------------------------------------------ exit contracts
def _tracer_with(events):
    t = Tracer()
    for kind, rid, data in events:
        t.emit(kind, rid, **data)
    return t


@pytest.mark.parametrize("tool", ["trace_report", "explain_request"])
def test_malformed_and_foreign_traces(tmp_path, tool):
    """A stream without a terminal is 1, garbage, a foreign Chrome trace and
    a missing file are 2 with a JSON error, for the port's tool as for the
    reference's."""
    torn = tmp_path / "torn.trace.json"
    _tracer_with([(EV_SUBMIT, 5, dict(prompt_len=4)),
                  (EV_QUEUED, 5, dict(queue_depth=1, bucket=8))]).export(torn)
    garbage = tmp_path / "garbage.bin"
    garbage.write_bytes(b"\x00\x01 definitely not json")
    foreign = tmp_path / "foreign.trace.json"
    foreign.write_text(json.dumps({"traceEvents": []}))
    lead = ("5",) if tool == "explain_request" else ()
    for path, code in ((torn, 1), (garbage, 2), (foreign, 2), (tmp_path / "missing.json", 2)):
        rc, out = _inproc(tool, *lead, path)
        assert rc == code, (path, out)
        if code == 2:
            assert json.loads(out)["error"]
    if tool == "trace_report":
        assert "ANOMALY" in _inproc(tool, torn)[1]


def test_explain_request_single_vs_merged_and_unknown_ids(served, tmp_path):
    trace = served / "trace.json"
    other = tmp_path / "other.trace.json"
    other.write_bytes(trace.read_bytes())
    single = json.loads(_inproc("explain_request", "2", trace, "--json")[1])
    merged = json.loads(_inproc("explain_request", "r1:2", other, trace, "--json")[1])
    for key in ("segments", "phase_totals", "coverage", "total_s", "gaps", "slowest_gaps",
                "tokens", "terminal"):
        assert single[key] == merged[key], key
    rc, out = _inproc("explain_request", "42", trace)
    assert rc == 2 and "not found" in json.loads(out)["error"]
    assert _inproc("explain_request", "r3:0", trace)[0] == 2


def test_journal_fsck_contracts(tmp_path):
    clean = tmp_path / "clean.journal"
    with RequestJournal(clean) as j:
        j.log_submit(Request([1, 2, 3], SamplingParams(max_new_tokens=4), request_id=0))
        j.log_first_token(0, 7, 1)
        j.log_finish(0, FINISH_LENGTH, [7, 8])
    anomalous = tmp_path / "anomalous.journal"
    with RequestJournal(anomalous) as j:
        j.log_first_token(99, 7, 1)  # tokens for a rid never submitted
    other = tmp_path / "not_a_journal"
    other.write_bytes(b"definitely not a journal")
    for path, code in ((clean, 0), (anomalous, 1), (other, 2)):
        rc, out = _inproc("journal_fsck", path)
        assert rc == code
        rep = json.loads(out)
        assert rep["error"] if code == 2 else rep["clean"] is (code == 0)


def test_serve_top_contracts(tmp_path):
    path = tmp_path / "telemetry.jsonl"
    point = {"_step": 5, "_ts": 1700000000.0, "serving/tokens_per_sec": 50.0,
             "supervisor/restarts": 1, "anomaly/active": 1,
             "anomaly/active_detectors": "itl_p99_s", "anomaly/events": 3,
             "anomaly/bundles": 1, "anomaly/last_event_age_s": 2.5,
             "anomaly/last_bundle": "/tmp/anomaly-0000-itl_p99_s.json"}
    path.write_text(json.dumps(point) + "\n")
    rc, out = _inproc("serve_top", path)
    assert rc == 0 and "alerts FIRING [itl_p99_s]" in out and "last event 2.5s ago" in out
    del point["anomaly/active"]
    path.write_text(json.dumps(point) + "\n")
    assert "alerts" not in _inproc("serve_top", path)[1]
    garbage = tmp_path / "garbage.jsonl"
    garbage.write_text('{"loss": 1.0, "_step": 1}\n')
    rc, out = _inproc("serve_top", garbage)
    assert rc == 2 and json.loads(out)["error"]
    assert _inproc("serve_top", tmp_path / "missing.jsonl")[0] == 2


def test_check_metrics_docs_detects_drift(tmp_path):
    doc = (_REPO / "docs" / "observability.md").read_text()
    stripped = tmp_path / "observability.md"
    stripped.write_text(doc.replace("serving/host_tier/", "serving/host_RENAMED/"))
    rc, out = _inproc("check_metrics_docs", "--doc", stripped, "--json")
    assert rc == 1 and "serving/host_tier" in json.loads(out)["missing_metrics"]
    assert _inproc("check_metrics_docs", "--doc", tmp_path / "missing.md")[0] == 2


def test_tools_import_only_the_port():
    for name in TOOLS:
        text = (_REPO / "accelerate_tpu_torch" / "tools" / f"{name}.py").read_text()
        assert not re.search(r"^\s*(from|import) (jax|flax|optax|accelerate_tpu)\b", text,
                             re.M), name
