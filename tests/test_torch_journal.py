"""The port's request journal (`accelerate_tpu_torch.serving.journal`) against
the reference's, on the CPU.

The byte format is shared, so each package's journal scans in the other: the
same calls write byte-identical files (with the clock pinned), a journal the
port writes scans with the reference's `RequestJournal.scan` into equal
`JournalScan` fields, and the reverse, including a journal the port's engine
writes while serving. Then the format's edges, as the reference's tests hold
them: a torn tail tolerated by `scan` and truncated on reopen, compaction
(explicit and automatic), the PROGRESS rewind of a quarantine's re-prefill,
and the refusal of a file that is not a journal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.serving import Request as JaxRequest  # noqa: E402
from accelerate_tpu.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from accelerate_tpu.serving import journal as jax_journal  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    FINISH_LENGTH,
    JournalError,
    Request,
    RequestJournal,
    SamplingParams,
    ServingEngine,
)
from accelerate_tpu_torch.serving import journal as port_journal  # noqa: E402
from accelerate_tpu_torch.serving.journal import (  # noqa: E402
    MAGIC,
    REC_FINISH,
    REC_FIRST_TOKEN,
    REC_PROGRESS,
    REC_SUBMIT,
)

SCAN_FIELDS = [f.name for f in dataclasses.fields(port_journal.JournalScan)]


def _write(journal_cls, request_cls, params_cls, path):
    """One scripted lifecycle through a package's writer: three submits (a
    deadline, a sampled seed, a cache opt-out), first tokens, progress, a
    finish."""
    with journal_cls(path) as j:
        j.log_submit(request_cls([1, 2, 3], params_cls(max_new_tokens=8, seed=0), request_id=0,
                                 deadline_s=2.5))
        j.log_submit(request_cls([4, 5], params_cls(temperature=0.9, top_k=5, seed=7,
                                                    max_new_tokens=4), request_id=1))
        j.log_submit(request_cls([6], params_cls(), request_id=2, cache_prefix=False))
        j.log_first_token(0, 7, 1)
        j.log_progress(0, [8, 9], 3)
        j.log_first_token(1, 4, 1)
        j.log_finish(1, FINISH_LENGTH, [4, 5, 6, 7])


def _scan_dict(scan):
    out = {name: getattr(scan, name) for name in SCAN_FIELDS}
    out["incomplete"] = scan.incomplete()
    out["truncated_tail_bytes"] = scan.truncated_tail_bytes
    return out


@pytest.fixture
def pinned_clock(monkeypatch):
    """Both writers stamp ``ts`` from ``time.time()``: pin it, so equal calls
    write equal bytes."""
    for mod in (port_journal, jax_journal):
        monkeypatch.setattr(mod.time, "time", lambda: 1234.5)


def test_same_calls_write_the_same_bytes(tmp_path, pinned_clock):
    _write(RequestJournal, Request, SamplingParams, tmp_path / "port.journal")
    _write(jax_journal.RequestJournal, JaxRequest, JaxSamplingParams, tmp_path / "ref.journal")
    port, ref = (tmp_path / "port.journal").read_bytes(), (tmp_path / "ref.journal").read_bytes()
    assert port.startswith(MAGIC) and MAGIC == jax_journal.MAGIC == b"ATSJRNL1"
    assert port == ref


def test_a_port_journal_scans_in_the_reference(tmp_path):
    path = tmp_path / "port.journal"
    _write(RequestJournal, Request, SamplingParams, path)
    got = _scan_dict(jax_journal.RequestJournal.scan(path))
    assert got == _scan_dict(RequestJournal.scan(path))
    assert got["records"] == 7 and got["anomalies"] == 0
    assert got["tokens"][0] == [7, 8, 9] and got["finishes"][1] == (FINISH_LENGTH, [4, 5, 6, 7])
    assert got["incomplete"] == [0, 2]
    # the port's requests have no priority or tenant yet: written as the
    # reference's defaults, so the record is the reference's
    assert got["submits"][2]["priority"] == 0 and got["submits"][2]["tenant"] == ""
    assert got["submits"][0]["deadline_s"] == 2.5 and not got["submits"][2]["cache_prefix"]


def test_a_reference_journal_scans_in_the_port(tmp_path):
    path = tmp_path / "ref.journal"
    _write(jax_journal.RequestJournal, JaxRequest, JaxSamplingParams, path)
    got = _scan_dict(RequestJournal.scan(path))
    assert got == _scan_dict(jax_journal.RequestJournal.scan(path))
    assert got["submits"][1]["params"] == {"temperature": 0.9, "top_k": 5, "seed": 7,
                                          "max_new_tokens": 4}


def test_an_engine_journal_scans_alike_in_both(tmp_path):
    """The port's engine journals a run cut mid-way: SUBMIT on acceptance,
    FIRST_TOKEN, PROGRESS every 2 tokens, FINISH; both scanners agree."""
    torch.manual_seed(0)
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    path = tmp_path / "engine.journal"
    engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(16,),
                           journal=RequestJournal(path, progress_every=2, fsync="never"))
    r = np.random.default_rng(0)
    for i, n in enumerate((5, 9, 3)):
        prompt = r.integers(0, 256, n).tolist()
        budget = 3 if i == 0 else 12
        assert engine.submit(Request(prompt, SamplingParams(max_new_tokens=budget))).accepted
    for _ in range(5):
        engine.step()
    engine.journal.close()
    got = _scan_dict(RequestJournal.scan(path))
    assert got == _scan_dict(jax_journal.RequestJournal.scan(path))
    assert got["records_by_type"][REC_SUBMIT] == 3
    assert got["records_by_type"][REC_FIRST_TOKEN] == len(got["admit_order"]) == 3
    assert got["records_by_type"][REC_PROGRESS] >= 2
    assert list(got["finishes"]) == [0] and len(got["finishes"][0][1]) == 3
    assert got["incomplete"] == [1, 2]  # mid-stream, in admission order
    assert engine.metrics.journal_records.value == got["records"]
    assert engine.metrics.journal_bytes.value == os.path.getsize(path) - len(MAGIC)


def test_progress_rewind_reconstruction(tmp_path):
    """A quarantine's re-prefill rewinds the stream; the cumulative ``n`` on
    each record makes the rewind self-describing."""
    p = tmp_path / "j.journal"
    with RequestJournal(p) as j:
        j.log_submit(Request([1], SamplingParams(), request_id=0))
        j.log_first_token(0, 10, 1)
        j.log_progress(0, [11, 12, 13], 4)
        j.log_first_token(0, 10, 1)  # re-prefill: the stream restarts at token 1
        j.log_progress(0, [11, 12], 3)
    for scan in (RequestJournal.scan(p), jax_journal.RequestJournal.scan(p)):
        assert scan.anomalies == 0 and scan.tokens[0] == [10, 11, 12]


def test_torn_tail_tolerated_and_truncated_on_reopen(tmp_path):
    p = tmp_path / "j.journal"
    with RequestJournal(p) as j:
        j.log_submit(Request([1, 2], SamplingParams(), request_id=0))
        j.log_first_token(0, 9, 1)
    with open(p, "ab") as f:
        f.write(b"\x40\x00\x00\x00\xde\xad\xbe")  # half a frame: the SIGKILL tear
    for scan in (RequestJournal.scan(p), jax_journal.RequestJournal.scan(p)):
        assert scan.records == 2 and scan.anomalies == 0
        assert scan.truncated_tail_bytes == 7
    # reopening truncates the tear before appending: records after garbage
    # would be unreachable (scan stops at the first bad frame)
    with RequestJournal(p) as j:
        j.log_finish(0, FINISH_LENGTH, [9, 8])
    scan = jax_journal.RequestJournal.scan(p)
    assert scan.truncated_tail_bytes == 0
    assert scan.records == 3 and scan.finishes[0] == (FINISH_LENGTH, [9, 8])


def test_rejects_a_file_that_is_not_a_journal(tmp_path):
    p = tmp_path / "not_a_journal"
    p.write_bytes(b"definitely not a journal")
    with pytest.raises(JournalError):
        RequestJournal.scan(p)
    with pytest.raises(JournalError):
        RequestJournal(p)
    with pytest.raises(ValueError, match="fsync"):
        RequestJournal(tmp_path / "j", fsync="sometimes")


def test_compact_collapses_progress_and_drops_finished(tmp_path):
    p = tmp_path / "j.journal"
    with RequestJournal(p) as j:
        for rid in range(3):
            j.log_submit(Request([rid], SamplingParams(), request_id=rid))
        j.log_first_token(0, 1, 1)
        for n in range(2, 12):
            j.log_progress(0, [n], n)
        j.log_first_token(1, 5, 1)
        j.log_finish(1, FINISH_LENGTH, [5, 6])
    before = os.path.getsize(p)
    assert RequestJournal.compact(p).records == 16  # the pre-compaction view
    after = jax_journal.RequestJournal.scan(p)  # the reference reads the rewrite
    assert os.path.getsize(p) < before and after.anomalies == 0
    assert 1 not in after.submits
    assert after.tokens[0] == list(range(1, 12))
    assert after.records_by_type == {REC_SUBMIT: 2, REC_PROGRESS: 1}
    with RequestJournal(p) as j:
        j.log_submit(Request([9], SamplingParams(), request_id=9))
        j.log_finish(9, FINISH_LENGTH, [7])
    RequestJournal.compact(p, keep_finished=True)
    kept = RequestJournal.scan(p)
    assert kept.finishes[9] == (FINISH_LENGTH, [7]) and kept.records_by_type[REC_FINISH] == 1


def test_auto_compaction_at_the_threshold(tmp_path):
    """Past ``compact_threshold_bytes`` the writer compacts in place at a
    record boundary, counts it, and re-arms above twice the live size."""
    p = tmp_path / "j.journal"
    j = RequestJournal(p, fsync="never", compact_threshold_bytes=600)
    for rid in range(6):
        j.log_submit(Request([rid] * 4, SamplingParams(), request_id=rid))
        j.log_first_token(rid, 1, 1)
        j.log_finish(rid, FINISH_LENGTH, [1])
    j.log_submit(Request([42], SamplingParams(), request_id=42))
    j.close()
    assert j.compactions >= 1
    scan = jax_journal.RequestJournal.scan(p)
    assert scan.anomalies == 0 and 42 in scan.submits
    assert len(scan.finishes) < 6  # finished requests compacted away
