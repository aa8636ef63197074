"""The port's spans (``utils/profiling.py``: ``span``, ``add``, ``enable``,
``take``) on the CPU, over tiny SD: nothing is recorded while recording is
off; nesting gives parent ids, also under many threads at once; three
concurrent ``submit``s give one ``serve.queued`` each and one
``serve.batch`` and ``serve.generate`` carrying all three ids, and the
server's queue-wait statistics read the same clock readings; each
generation holds its host phases, programs and fetches in order, each
inside its parent, an SD3 generation (MMDiT, T5, rectified flow) the same
ones; a second call of a key builds and captures nothing.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import statistics
import sys
import threading

import numpy as np
import pytest

from ml_stable_diffusion_torch import serving
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration
from ml_stable_diffusion_torch.utils import profiling

from torch_helpers import port_sd3_pipeline, port_sd_pipeline

HW = (64, 64)


def _cfg(prompt="a cat", seed=1, **kw):
    return PipelineConfiguration(**{**dict(prompt=prompt, seed=seed, step_count=2,
                                           scheduler="DDIM", disable_safety=True,
                                           rng="numpy"), **kw})


@pytest.fixture
def recording():
    """Recording on for the test, off and emptied after it."""
    profiling.take()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.take()


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    return port_sd_pipeline(tmp_path_factory.mktemp("tok"), seed=91, encoder=False)


def _children(records, parent):
    return sorted((r for r in records if r.parent_id == parent.span_id),
                  key=lambda r: r.start_ns)


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_off_records_nothing():
    profiling.disable()
    profiling.take()
    first = profiling.span("pipeline.plan")
    assert first is profiling.span("serve.batch", size=3) is profiling._NO_SPAN
    with first as s:
        s.note(size=1)
    profiling.add("serve.queued", 0, 1, request=1)
    assert profiling.take() == []


def test_nesting_gives_parent_ids(recording):
    with profiling.span("outer", images=2) as outer:
        with profiling.span("middle"):
            with profiling.span("inner"):
                pass
        with profiling.span("second"):
            pass
        outer.note(size=4)
    profiling.add("across", 5, 9, request=7)
    recs = {r.name: r for r in profiling.take()}
    assert list(recs) == ["inner", "middle", "second", "outer", "across"]  # as they closed
    assert recs["outer"].parent_id is None and recs["across"].parent_id is None
    assert recs["middle"].parent_id == recs["second"].parent_id == recs["outer"].span_id
    assert recs["inner"].parent_id == recs["middle"].span_id
    assert recs["outer"].attrs == {"images": 2, "size": 4}
    assert (recs["across"].start_ns, recs["across"].end_ns) == (5, 9)
    assert all(_inside(recs[n], recs["outer"]) for n in ("middle", "inner", "second"))
    assert len({r.span_id for r in recs.values()}) == 5
    assert {r.thread_id for r in recs.values()} == {threading.get_ident()}
    assert profiling.take() == []


def test_threads_keep_their_own_nesting(recording):
    """More threads than cores, the interpreter switching threads every
    microsecond: no record is lost and each parent is the thread's own."""
    n_threads, n_spans = 24, 150
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with profiling.span("outer"):
                    with profiling.span("inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = profiling.take()
    assert len(recs) == 2 * n_threads * n_spans
    by_id = {r.span_id: r for r in recs}
    assert len(by_id) == len(recs)
    for r in recs:
        if r.name == "inner":
            parent = by_id[r.parent_id]
            assert parent.name == "outer" and parent.thread_id == r.thread_id
            assert _inside(r, parent)
        else:
            assert r.parent_id is None


def _generation_phases(recs, top):
    """The spans under ``top`` (a serve.generate, or None for a direct call
    on this thread) as [(name, attrs, [(child name, attrs)])], in order,
    each checked to lie inside its parent."""
    out = []
    for r in _children(recs, top) if top is not None else sorted(
            (r for r in recs if r.parent_id is None and r.name.startswith("pipeline.")),
            key=lambda r: r.start_ns):
        if top is not None:
            assert _inside(r, top)
        kids = _children(recs, r)
        assert all(_inside(k, r) for k in kids)
        out.append((r.name, r.attrs, [(k.name, k.attrs) for k in kids]))
    return out


def _expected_phases(images, path="program"):
    programs = path == "program"
    gen = [("program.lookup", {"kind": "generation"}), ("program.fill", {"kind": "generation"}),
           ("program.run", {"kind": "generation"})] if programs else []
    dec = [("program.lookup", {"kind": "decode"}), ("program.fill", {"kind": "decode"}),
           ("program.run", {"kind": "decode"})] if programs else []
    return [("pipeline.plan", {}, []), ("pipeline.host_inputs", {}, []),
            ("pipeline.denoise", {"path": path}, gen + [("pipeline.fetch", {})]),
            ("pipeline.decode", {"images": images}, dec + [("pipeline.fetch", {})])]


def test_generation_phases_in_order_and_no_second_build(pipe, recording):
    pipe.generate_images(_cfg(seed=3), image_hw=HW)
    built = pipe._programs.built
    pipe.generate_images(_cfg("a dog", seed=4), image_hw=HW)
    assert pipe._programs.built == built  # the second call replays both programs
    recs = profiling.take()
    phases = _generation_phases(recs, None)
    assert phases == _expected_phases(1) * 2
    # on the CPU a program's body runs uncaptured: only the card captures
    assert not [r for r in recs if r.name == "program.capture"]
    pipe.execution = "eager"
    try:
        pipe.generate_images(_cfg(seed=5), image_hw=HW)
    finally:
        pipe.execution = "program"
    assert _generation_phases(profiling.take(), None) == _expected_phases(1, "eager")


def test_sd3_generation_holds_the_same_phases(tmp_path, recording):
    """SD3 inherits the phases from pipelines/sd.py: its MMDiT, T5 and flow
    steps run inside ``program.run``, its decode in a program of its own."""
    sd3 = port_sd3_pipeline(tmp_path, seed=93)
    for seed in (3, 4):
        sd3.generate_images(_cfg(seed=seed, scheduler="DiscreteFlow", guidance_scale=4.5),
                            image_hw=HW)
    assert _generation_phases(profiling.take(), None) == _expected_phases(1) * 2


def test_served_batch_carries_every_request_id(pipe, recording):
    server = serving.GenerationServer(pipe, max_batch=4, batch_window_s=1.0)
    try:
        futs = [server.submit(_cfg(p, s), image_hw=HW)
                for p, s in (("a cat", 1), ("a dog", 2), ("a fish", 3))]
        for f in futs:
            assert np.isfinite(f.result(timeout=600).latents).all()
        assert server.batches_run == 1 and server.requests_served == 3
        # a multi-image request cannot merge: the worker pool runs it, with its own id
        assert server.submit(_cfg(seed=9, image_count=2), image_hw=HW).result(
            timeout=600).images.shape[0] == 2
        stats = server.stats()
    finally:
        server.shutdown()
    recs = profiling.take()
    queued = [r for r in recs if r.name == "serve.queued"]
    batches = [r for r in recs if r.name == "serve.batch"]
    generates = sorted((r for r in recs if r.name == "serve.generate"),
                       key=lambda r: r.start_ns)
    ids = tuple(sorted(r.attrs["request"] for r in queued))
    assert len(queued) == 3 and len(set(ids)) == 3
    assert len(batches) == 1 and batches[0].attrs == {"size": 3, "requests": ids}
    assert [g.attrs for g in generates][0] == {"requests": ids, "images": 3}
    assert len(generates) == 2 and generates[1].attrs["images"] == 2
    assert generates[1].attrs["requests"][0] not in ids
    # each request waited until its batch closed, taken at one clock reading
    assert len({q.end_ns for q in queued}) == 1
    assert all(q.start_ns < q.end_ns and batches[0].start_ns <= q.end_ns
               <= batches[0].end_ns <= generates[0].start_ns for q in queued)
    assert min(q.start_ns for q in queued) <= batches[0].start_ns
    assert _generation_phases(recs, generates[0]) == _expected_phases(3)
    assert _generation_phases(recs, generates[1]) == _expected_phases(2)
    # the batcher waited for work after the batch, until the shutdown
    assert [r for r in recs if r.name == "serve.idle"]
    waits = [(q.end_ns - q.start_ns) * 1e-9 for q in queued]
    assert stats["queue_wait_median_s"] == round(statistics.median(waits), 4)
    assert stats["queue_wait_p90_s"] == round(
        statistics.quantiles(waits, n=10, method="inclusive")[-1], 4)
    assert stats["requests_served"] == 4 and stats["e2e_latency_median_s"] > 0


def test_queue_waits_are_kept_with_recording_off(pipe):
    profiling.disable()
    server = serving.GenerationServer(pipe, max_batch=4, batch_window_s=0.0)
    try:
        assert server.stats()["queue_wait_p90_s"] is None
        server.submit(_cfg(seed=6), image_hw=HW).result(timeout=600)
        stats = server.stats()
    finally:
        server.shutdown()
    assert stats["queue_wait_median_s"] == stats["queue_wait_p90_s"] >= 0
    assert profiling.take() == []
