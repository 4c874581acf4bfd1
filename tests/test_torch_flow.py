"""Flow control without a server (flow/, client/retry.py, stats), through
both packages: the server-free cases of tests/test_flow.py run once
against the JAX package's copies and once against the port's (`p`,
parametrised): token buckets, hierarchical quotas, overload shedding,
the client's jittered retry, credit windows and the stats shards.

Quota/rate tests run on a fake clock — zero wall-clock sleeps.
"""

import importlib
import threading
from types import SimpleNamespace

import grpc
import pytest

PACKAGES = ("hstream_tpu", "hstream_tpu_torch")


def _package(root: str) -> SimpleNamespace:
    flow = importlib.import_module(f"{root}.flow")
    retry = importlib.import_module(f"{root}.client.retry")
    return SimpleNamespace(
        RetryPolicy=retry.RetryPolicy,
        retry_after_ms_from_error=retry.retry_after_ms_from_error,
        ResourceExhausted=importlib.import_module(
            f"{root}.common.errors").ResourceExhausted,
        StatsHolder=importlib.import_module(f"{root}.stats").StatsHolder,
        **{name: getattr(flow, name) for name in (
            "ADMIT", "DEFER", "REJECT", "CreditWindow", "FlowGovernor",
            "OverloadDetector", "Quota", "QuotaTree", "TokenBucket",
            "tenant_of")})


@pytest.fixture(params=PACKAGES)
def p(request):
    return _package(request.param)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def test_bucket_burst_then_sustained_rate(p):
    clk = FakeClock()
    b = p.TokenBucket(100.0, 100.0, clock=clk)
    # the whole burst is admissible immediately...
    assert b.try_take(100.0) == 0.0
    # ...then the bucket is empty and reports the accrual wait
    wait = b.try_take(10.0)
    assert wait == pytest.approx(0.1)
    clk.advance(0.5)  # 50 tokens accrue
    assert b.try_take(50.0) == 0.0
    assert b.try_take(1.0) > 0.0


def test_bucket_debt_converges_on_rate(p):
    """Unconditional take (charge-after-read) goes into debt; refills
    repay it before anything else is admitted."""
    clk = FakeClock()
    b = p.TokenBucket(10.0, 10.0, clock=clk)
    b.take(30.0)  # 20 tokens of debt
    assert b.try_take(1.0) > 0.0
    clk.advance(2.0)  # exactly repays the debt
    assert b.tokens == pytest.approx(0.0)
    clk.advance(0.1)
    assert b.try_take(1.0) == 0.0


def test_tenant_of(p):
    assert p.tenant_of("acme/orders") == "acme"
    assert p.tenant_of("acme.events") == "acme"
    assert p.tenant_of("acme.a/b") == "acme"
    assert p.tenant_of("plain") is None


def test_quota_tree_stream_and_tenant_levels(p):
    clk = FakeClock()
    tree = p.QuotaTree(clk)
    tree.set("stream/acme.a", p.Quota(records_per_s=10, burst_records=10))
    tree.set("tenant/acme", p.Quota(records_per_s=15, burst_records=15))
    # stream cap binds first
    assert tree.admit_append("acme.a", 10, 0) == 0.0
    assert tree.admit_append("acme.a", 1, 0) > 0.0
    # the sibling stream has no stream-level quota but shares the tenant
    # budget, of which acme.a already consumed 10
    assert tree.admit_append("acme.b", 5, 0) == 0.0
    assert tree.admit_append("acme.b", 1, 0) > 0.0
    # an unrelated tenant is untouched
    assert tree.admit_append("other.x", 100, 0) == 0.0


def test_quota_tree_refusal_consumes_nothing(p):
    clk = FakeClock()
    tree = p.QuotaTree(clk)
    tree.set("stream/s", p.Quota(records_per_s=10, burst_records=10,
                               bytes_per_s=100, burst_bytes=100))
    assert tree.admit_append("s", 1, 100) == 0.0  # drain bytes bucket
    # bytes level refuses -> the records bucket must not be charged
    assert tree.admit_append("s", 1, 50) > 0.0
    assert tree.admit_append("s", 9, 0) == 0.0  # 9 record tokens intact


def test_offered_10x_admitted_at_quota_rate(p):
    """Acceptance bar: 10xR offered load admits at R (+/-10%), rejects
    carry retry-after hints. Fake clock, zero sleeps."""
    clk = FakeClock()
    gov = p.FlowGovernor(clock=clk)
    R = 100.0
    gov.quotas.set("stream/s", p.Quota(records_per_s=R, burst_records=R))
    gov._recompute_active()
    assert gov.active
    admitted = 0
    hints = []
    seconds = 20
    per_tick = 10  # 10ms ticks x 10 records = 1000/s offered = 10xR
    for _ in range(seconds * 100):
        clk.advance(0.01)
        try:
            gov.admit_append("s", per_tick, 0)
            admitted += per_tick
        except p.ResourceExhausted as e:
            assert e.retry_after_ms is not None and e.retry_after_ms >= 1
            hints.append(e.retry_after_ms)
    expected = R * seconds
    # +burst_records of slack for the initial full bucket
    assert 0.9 * expected <= admitted <= 1.1 * expected + R
    assert hints, "over-quota offered load must produce refusals"


def test_quota_rejects_non_positive_rates(p):
    with pytest.raises(ValueError):
        p.Quota(records_per_s=0)
    with pytest.raises(ValueError):
        p.Quota(bytes_per_s=-5)
    with pytest.raises(ValueError):
        p.Quota.from_json({"records_per_s": 0})
    with pytest.raises(ValueError):
        p.Quota(burst_records=10)  # burst without rate enforces nothing
    with pytest.raises(ValueError):
        p.Quota()  # all-None quota is a no-op, not a limit


def test_oversize_batch_admits_into_debt_with_truthful_hint(p):
    """A batch larger than the burst admits at a full bucket (going
    into debt) — the retry-after hint is always achievable, never a
    forever-retry trap."""
    clk = FakeClock()
    gov = p.FlowGovernor(clock=clk)
    gov.set_quota("stream/s", p.Quota(records_per_s=100, burst_records=100))
    gov.admit_append("s", 150, 0)  # full bucket: admitted, 50 in debt
    with pytest.raises(p.ResourceExhausted) as ei:
        gov.admit_append("s", 150, 0)
    # waiting out the hint makes the SAME request admissible
    clk.advance(ei.value.retry_after_ms / 1000.0)
    gov.admit_append("s", 150, 0)
    # and the next oversize batch waits again (debt repaid at the rate)
    wait = gov.quotas.admit_append("s", 150, 0)
    assert 0 < wait <= 60.0


def test_quota_unset_deactivates_hot_path(p):
    gov = p.FlowGovernor(clock=FakeClock())
    assert not gov.active
    gov.set_quota("stream/s", p.Quota(records_per_s=5))
    assert gov.active
    gov.unset_quota("stream/s")
    assert not gov.active


def test_overload_detector_transitions_from_pipeline_signals(p):
    det = p.OverloadDetector()
    assert det.level == p.ADMIT
    # synthetic pipeline-stage occupancy ramps: EWMA needs sustained
    # high samples (one spike is not overload)
    det.note("pipeline_occupancy", 0.99)
    assert det.level == p.ADMIT  # ewma at ~0.5 after one sample
    for _ in range(6):
        det.note("pipeline_occupancy", 0.99)
    assert det.level == p.REJECT
    # recovery requires sustained low samples too
    det.note("pipeline_occupancy", 0.0)
    assert det.level in (p.DEFER, p.REJECT)
    for _ in range(8):
        det.note("pipeline_occupancy", 0.0)
    assert det.level == p.ADMIT


def test_overload_detector_rejects_unknown_signal(p):
    with pytest.raises(KeyError):
        p.OverloadDetector().note("nope", 1.0)


def test_idle_sources_do_not_mask_overloaded_one(p):
    """Per-source max aggregation: three idle subscriptions feeding
    zeros cannot average away one subscription's critical backlog."""
    det = p.OverloadDetector()
    for _ in range(10):
        det.note("sub_backlog", 150_000.0, source="hot")
        for idle in ("a", "b", "c"):
            det.note("sub_backlog", 0.0, source=idle)
    assert det.effective_level() == p.REJECT


def test_stale_signal_expires_per_signal(p):
    """A producer that died at critical (e.g. a deleted subscription's
    backlog feed) must expire on its own clock — other signals staying
    fresh and healthy cannot pin the shed level."""
    clk = FakeClock()
    det = p.OverloadDetector(clock=clk, stale_after_s=10.0)
    for _ in range(10):
        det.note("sub_backlog", 500_000.0)
    assert det.effective_level() == p.REJECT
    # the backlog feed dies; a healthy query keeps feeding low latency
    for _ in range(30):
        clk.advance(1.0)
        det.note("step_latency_ms", 1.0)
    assert det.effective_level() == p.ADMIT  # stale critical expired
    # and a revived feed counts again
    for _ in range(10):
        det.note("sub_backlog", 500_000.0)
    assert det.effective_level() == p.REJECT


def test_shed_ladder_background_before_user(p):
    gov = p.FlowGovernor(clock=FakeClock())
    det = gov.overload
    # p.DEFER: background sheds, user appends flow
    for _ in range(8):
        det.note("step_latency_ms", 400.0)
    assert det.level == p.DEFER and gov.active
    assert gov.admit_background("connector") > 0.0
    gov.admit_append("s", 1, 10)  # no quota, not rejected at p.DEFER
    # p.REJECT: user appends refused with a retry-after hint
    for _ in range(8):
        det.note("step_latency_ms", 10_000.0)
    assert det.level == p.REJECT
    with pytest.raises(p.ResourceExhausted) as ei:
        gov.admit_append("s", 1, 10)
    assert ei.value.retry_after_ms is not None
    assert gov.admit_background("connector") > 0.0
    assert gov.shed_by_class["user"] == 1
    assert gov.shed_by_class["background"] == 2


class FakeExhausted(grpc.RpcError):
    def __init__(self, retry_after_ms=None):
        self._ra = retry_after_ms

    def code(self):
        return grpc.StatusCode.RESOURCE_EXHAUSTED

    def details(self):
        if self._ra is None:
            return "quota exceeded"
        return f"quota exceeded (retry_after_ms={self._ra})"

    def trailing_metadata(self):
        if self._ra is None:
            return ()
        return (("retry-after-ms", str(self._ra)),)


def test_retry_after_parsing_metadata_and_text(p):
    assert p.retry_after_ms_from_error(FakeExhausted(120)) == 120

    class TextOnly(FakeExhausted):
        def trailing_metadata(self):
            return ()

    assert p.retry_after_ms_from_error(TextOnly(77)) == 77
    assert p.retry_after_ms_from_error(FakeExhausted()) is None


def test_client_retry_converges_on_quota_without_herd(p):
    """N clients against one fake-clock governor: every client's call
    eventually lands, total admissions track the quota, and the jittered
    delays are spread (no thundering herd). Zero wall-clock sleeps."""
    import random

    clk = FakeClock()
    lock = threading.Lock()  # governor is shared; test is single-threaded
    gov = p.FlowGovernor(clock=clk)
    R = 50.0
    gov.set_quota("stream/s", p.Quota(records_per_s=R, burst_records=R))

    def server_append(n):
        with lock:
            try:
                gov.admit_append("s", n, 0)
            except p.ResourceExhausted as e:
                raise FakeExhausted(e.retry_after_ms)

    delays: list[float] = []

    def make_client(seed):
        def fake_sleep(s):
            delays.append(s)
            clk.advance(s)

        return p.RetryPolicy(attempts=10, sleep=fake_sleep,
                           rng=random.Random(seed))

    clients = [make_client(i) for i in range(20)]
    done = 0
    for round_i in range(5):
        for c in clients:
            c.call(server_append, 5)  # raises if it cannot converge
            done += 1
    assert done == 100
    total_retries = sum(c.retries for c in clients)
    assert total_retries > 0, "10x load must have caused retries"
    # jitter: the backoff delays must not collapse onto one value
    assert len({round(d, 6) for d in delays}) > len(delays) // 2


def test_credit_window_take_refill(p):
    w = p.CreditWindow(8)
    assert w.take_up_to(5) == 5
    assert w.take_up_to(5) == 3
    assert w.take_up_to(1, timeout=0.01) == 0
    w.refill(4)
    assert w.take_up_to(100) == 4
    w.refill(1000)  # capped at the window
    assert w.available == 8



def test_stats_shards_bounded_across_thread_churn(p):
    """Counter shards of exited threads fold into a retired aggregate
    on read: totals exact, shard list bounded."""
    h = p.StatsHolder()
    h.stream_stat_add("append_total", "s", 1)  # main-thread shard

    def bump():
        h.stream_stat_add("append_total", "s", 2)

    for _ in range(40):
        t = threading.Thread(target=bump)
        t.start()
        t.join()
    assert h.stream_stat_get("append_total", "s") == 1 + 40 * 2
    assert len(h._shards) <= 2  # main + at most one straggler
    # getall folds the same way
    assert h.stream_stat_getall("append_total") == {"s": 81}

