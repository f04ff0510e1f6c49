"""Multi-replica serving: the port of `accelerate_tpu.serving.cluster`. A
prefix-aware, health-aware router over supervised engines, with
journal-backed migration.

`ServingCluster` fronts N `EngineSupervisor`-wrapped replicas behind the
single engine's ``submit`` / ``step`` / ``drain`` surface, so a caller goes
from one replica to N by changing a constructor argument, never its serving
loop. Three duties, all on the host:

**Placement** is prefix-aware: each replica's radix trie
(`serving.prefix_cache`) answers `PrefixCache.match_len`, a cheap probe that
pins nothing, and a request goes to the replica that holds the longest cached
prefix of its prompt, ties broken by load (queue depth + active slots).
Routing only chooses which replica serves a request: every replica runs the
same model, so the tokens are the same whichever it is (the cluster parity
contract). ``policy="round_robin"`` is the affinity-blind baseline.

**Health gating** reads each supervisor's `heartbeat()`: an unhealthy
replica takes no admissions, a stalled one is avoided while a calm one
exists (a cluster that is all slow still admits), and a replica in overload
brownout gets no admission its own gate would shed (``priority <
brownout_level``): the router sends it to a calm replica instead.

**Migration** is journal-backed: when a replica's `RestartBudget` is spent,
its supervisor fails it loudly and every request in flight is journaled as
``rejected:unhealthy`` with its partial stream. The cluster intercepts that
death, scans the dead replica's journal (the source of truth), delivers the
requests that really finished, and resubmits the rest to healthy replicas
with their emitted tokens as ``resume_tokens``: one continuation prefill and
a fast-forwarded generator continue each stream as the uninterrupted run
does, so a replica kill loses no request and generates no emitted token
again. The resumed prefix is journaled on the target replica, so a second
kill is just another migration.

Replica **roles** (``prefill`` / ``decode`` / ``mixed``) are a routing field:
fresh admissions go to prefill-capable replicas, migrated continuations
prefer decode-capable ones. With every replica ``mixed`` (the default) the
field does nothing.

The **elastic fleet** (`add_replica`, `retire_replica`, `replace_replica`,
driven by `serving.autoscaler`): a replica is OK, DRAINING (no new
placements, still stepped until its work finishes or migrates), DEAD (budget
spent, awaiting replacement) or RETIRED (journal closed, device memory given
back, index never reused).

On CUDA every replica is its own engine over one model the factory closes
over: the weights are held once, and each replica owns its KV pool, its
captured decode graph and its staging buffers. Replicas are stepped one
after another in the caller's thread, each engine's work on the one stream,
as the reference steps them; a replica spawned under traffic captures its
graph between two other replicas' steps.

Request ids: each engine stamps its own, so the cluster owns a cluster-level
id space and translates both ways: callers see one monotone id sequence
whatever the placement, as with a single engine.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable

from ..reliability import faults
from .journal import RequestJournal
from .metrics import ServingMetrics, aggregate_snapshots
from .request import (
    FINISH_EOS,
    FINISH_LENGTH,
    REJECT_OVERLOAD,
    REJECT_UNHEALTHY,
    Request,
    RequestOutput,
    SamplingParams,
    SubmitResult,
)
from .supervisor import EngineSupervisor, EngineUnhealthyError, SupervisorConfig
from .trace import EV_MIGRATE, EV_ROUTE, EV_SCALE

# replica roles
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_MIXED = "mixed"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_MIXED)

# placement policies
POLICY_PREFIX = "prefix"
POLICY_ROUND_ROBIN = "round_robin"
POLICIES = (POLICY_PREFIX, POLICY_ROUND_ROBIN)

# replica lifecycle states: OK serves; DRAINING takes no placements but is
# stepped until its work finishes or migrates; DEAD is a budget-exhausted
# supervisor awaiting replacement; RETIRED is terminal (journal closed,
# device memory released, index never reused; the handle stays in
# ``replicas`` so positional lookups stay valid)
STATE_OK = "ok"
STATE_DRAINING = "draining"
STATE_DEAD = "dead"
STATE_RETIRED = "retired"
STATES = (STATE_OK, STATE_DRAINING, STATE_DEAD, STATE_RETIRED)

_UNHEALTHY_REASON = f"rejected:{REJECT_UNHEALTHY}"


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Knobs of the routing layer (the reference's).

    - ``policy``: ``"prefix"`` (longest cached prefix, ties by load) or
      ``"round_robin"`` (the affinity-blind baseline);
    - ``roles``: one role per replica; None makes every replica ``mixed``;
    - ``migrate``: journal-backed migration off a budget-exhausted replica
      (True, the default). With False a dead replica's backlog is delivered
      as ``rejected:unhealthy``, the lone supervisor's fail-loud end.
    """

    policy: str = POLICY_PREFIX
    roles: tuple[str, ...] | None = None
    migrate: bool = True

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {self.policy!r}")
        if self.roles is not None:
            bad = [r for r in self.roles if r not in ROLES]
            if bad:
                raise ValueError(f"roles must be drawn from {ROLES}, got {bad}")


class _SumCounter:
    """A `metrics.Counter` look-alike (``.value``) over a live sum."""

    __slots__ = ("_fn",)

    def __init__(self, fn: Callable[[], int]):
        self._fn = fn

    @property
    def value(self) -> int:
        return self._fn()


class _ClusterMetricsView:
    """The cluster's ``metrics``: the part of `ServingMetrics` the telemetry
    exporter reads (``snapshot()``, ``steps``) as a live sum over the
    replicas' own metrics (`metrics.aggregate_snapshots`), plus the
    ``cluster/*`` routing gauges and the autoscaler's. Each replica's detail
    is exported under ``replica<i>/`` (`serving.telemetry`)."""

    def __init__(self, cluster: "ServingCluster"):
        self._cluster = cluster
        self.steps = _SumCounter(lambda: sum(r.metrics.steps.value for r in cluster.replicas))

    def snapshot(self) -> dict[str, Any]:
        cluster = self._cluster
        out = aggregate_snapshots([r.metrics.snapshot() for r in cluster.replicas])
        out.update(cluster.router_stats())
        if cluster.autoscaler is not None:
            out.update(cluster.autoscaler.gauges())
        return out


class ReplicaHandle:
    """One supervised replica: its index, role, supervisor, journal and
    place in the lifecycle (the ``STATE_*`` constants). ``index`` is never
    reused: a retired handle stays in ``ServingCluster.replicas``, so
    ``replicas[i].index == i`` holds."""

    __slots__ = ("index", "role", "supervisor", "journal_path", "metrics", "draining", "retired",
                 "migrated")

    def __init__(self, index: int, role: str, supervisor: EngineSupervisor, journal_path: Path,
                 metrics: ServingMetrics):
        self.index = index
        self.role = role
        self.supervisor = supervisor
        self.journal_path = journal_path
        self.metrics = metrics
        self.draining = False
        self.retired = False
        # whether this replica's journal backlog was migrated already (by
        # step's death intercept or a forced retire): replace_replica must not
        # migrate it again and duplicate the resubmits
        self.migrated = False

    @property
    def healthy(self) -> bool:
        return not self.retired and not self.supervisor.unhealthy

    @property
    def state(self) -> str:
        if self.retired:
            return STATE_RETIRED
        if self.supervisor.unhealthy:
            return STATE_DEAD
        if self.draining:
            return STATE_DRAINING
        return STATE_OK

    @property
    def accepting(self) -> bool:
        """Eligible for new placements: healthy and not retiring."""
        return self.healthy and not self.draining

    @property
    def engine(self) -> Any:
        return self.supervisor.engine


class ServingCluster:
    """N supervised replicas behind the single engine's serving API (module
    docstring). ``engine_factory`` is the factory a lone `EngineSupervisor`
    takes: it must forward ``journal=``, ``metrics=`` and ``tracer=`` into
    `ServingEngine` and reuse one model, so every replica (and every
    rebuild) serves the same weights, held once::

        cluster = ServingCluster(
            lambda **kw: ServingEngine(model, max_concurrency=16, paged_kv=True,
                                       paged_attention="fused",
                                       prefix_cache=PrefixCacheConfig(), **kw),
            workdir, replicas=2, supervisor_config=SupervisorConfig(max_restarts=1))
        rid = cluster.submit(prompt).request_id
        while cluster.has_work:
            for out in cluster.step(): ...

    Replica ``i`` journals to ``workdir/replica{i}/requests.journal``; a
    cluster built over a populated workdir resumes every replica (the
    supervisors recover at construction) and announces the recovered streams
    under fresh cluster ids. ``tracers`` and ``headroom_fns`` are optional
    per-replica sequences forwarded to each supervisor; ``clock`` is
    injectable."""

    def __init__(
        self,
        engine_factory: Callable[..., Any],
        workdir: str | Path,
        *,
        replicas: int = 2,
        config: ClusterConfig | None = None,
        supervisor_config: SupervisorConfig | None = None,
        tracers: Any = None,
        headroom_fns: Any = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.config = config if config is not None else ClusterConfig()
        roles = self.config.roles
        if roles is not None and len(roles) != replicas:
            raise ValueError(f"roles has {len(roles)} entries for {replicas} replicas")
        self.workdir = Path(workdir)
        self._clock = clock
        self._factory = engine_factory
        self._supervisor_config = supervisor_config
        self._next_rid = 0
        self._rr = 0  # round-robin cursor
        # cluster rid <-> (replica index, engine rid); a migrated request
        # keeps its cluster rid across placements
        self._routes: dict[int, tuple[int, int]] = {}
        self._by_engine: dict[tuple[int, int], int] = {}
        self._delivered: set[int] = set()
        # cluster-id outputs made outside step() (replace_replica's
        # migration), handed out by the next step()
        self._pending_outputs: list[RequestOutput] = []
        self._last_rank: dict[int, dict[str, int]] = {}
        self.migrations = 0  # replica deaths migrated
        self.migrated_requests = 0
        self.retired_replicas = 0
        self.replaced_replicas = 0
        self._routed = {POLICY_PREFIX: 0, POLICY_ROUND_ROBIN: 0}
        self._route_match_tokens = 0
        # a FleetAutoscaler attaches itself here (serving.autoscaler); step()
        # then runs one control evaluation a cluster step
        self.autoscaler: Any = None
        self._next_replica_index = 0
        self.replicas: list[ReplicaHandle] = []
        for i in range(replicas):
            self.add_replica(role=roles[i] if roles is not None else ROLE_MIXED,
                             tracer=tracers[i] if tracers is not None else None,
                             headroom_fn=headroom_fns[i] if headroom_fns is not None else None)
        self.metrics = _ClusterMetricsView(self)

    # --- the elastic fleet -------------------------------------------------------
    def add_replica(self, role: str = ROLE_MIXED, *, tracer: Any = None,
                    headroom_fn: Callable[[], dict[str, Any]] | None = None) -> ReplicaHandle:
        """Spawn one replica through the construction-time factory into
        ``workdir/replica<i>/`` under the next never-used index. The
        ``cluster.replica_spawn`` fault point fires before anything touches
        the disk, so a failed spawn leaves nothing behind and may be retried
        (the autoscaler's seeded `RetryPolicy`). On CUDA the new engine
        captures its decode graph here."""
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        faults.fault_point(faults.SCOPE_REPLICA_SPAWN)
        index = self._next_replica_index
        rep_dir = self.workdir / f"replica{index}"
        rep_dir.mkdir(parents=True, exist_ok=True)
        metrics = ServingMetrics()
        sup = EngineSupervisor(self._factory, rep_dir / "requests.journal",
                               config=self._supervisor_config, metrics=metrics, tracer=tracer,
                               headroom_fn=headroom_fn)
        rep = ReplicaHandle(index, role, sup, rep_dir / "requests.journal", metrics)
        self._next_replica_index += 1
        self.replicas.append(rep)
        return rep

    def retire_replica(self, index: int, *, force: bool = False) -> list[RequestOutput]:
        """Begin (or with ``force`` complete) the drain-and-retire lifecycle
        of one replica. DRAINING takes it out of placement (`_eligible`)
        while `step` keeps stepping its work; once idle `step` retires it
        (journal closed, no request lost). ``force=True`` ends the grace
        now: the remaining work journal-migrates to peers (streams unchanged)
        and the replica retires at once. Returns the cluster-id outputs the
        forced migration delivered."""
        rep = self.replicas[index]
        if rep.retired:
            return []
        sup = rep.supervisor
        if sup.unhealthy:
            # failed loudly already: its journal is closed and its backlog
            # migrated (step's intercept) or accounted for
            self._finalize_retire(rep)
            return []
        rep.draining = True
        sup.begin_drain()
        if not force:
            return []
        if self.config.migrate:
            produced = self._migrate(rep, rep.engine.abort_all(reason=_UNHEALTHY_REASON))
            rep.migrated = True
        else:
            produced = rep.engine.abort_all()
        outputs = self._translate(rep.index, produced)
        self._finalize_retire(rep)
        return outputs

    def replace_replica(self, index: int) -> ReplicaHandle:
        """Replace a DEAD (budget-exhausted) replica: spawn a successor under
        a fresh index, migrate the dead journal into the fleet (unless
        `step`'s intercept did) and retire the dead handle. ValueError on a
        live or retired replica; a spawn failure (the
        ``cluster.replica_spawn`` fault point) propagates before any state
        changes, so the caller may retry. Returns the successor."""
        dead = self.replicas[index]
        if dead.retired:
            raise ValueError(f"replica {index} is already retired")
        if not dead.supervisor.unhealthy:
            raise ValueError(f"replica {index} is alive: use retire_replica")
        successor = self.add_replica(role=dead.role)
        if self.config.migrate and not dead.migrated:
            # a replica that died outside step() still owes its backlog to
            # the fleet; what it delivers surfaces at the next step()
            self._pending_outputs.extend(self._translate(dead.index, self._migrate(dead, [])))
            dead.migrated = True
        self._finalize_retire(dead, emit=False)
        self.replaced_replicas += 1
        tracer = getattr(successor.engine, "tracer", None)
        if tracer is not None and tracer.enabled:
            tracer.emit(EV_SCALE, None, action="replace", replica=successor.index,
                        replaced=dead.index, live=self.live_replicas)
        return successor

    def _finalize_retire(self, rep: ReplicaHandle, *, emit: bool = True) -> None:
        """DRAINING/DEAD -> RETIRED: close the journal (a fail-loud
        supervisor closed it already), release the engine's device memory
        (its KV pool, its decode graph and the graph's memory pool, its
        pinned rings), keep the handle (stable indices) and stop its
        telemetry (`replica_samples` skips it)."""
        if rep.retired:
            return
        engine = rep.engine
        tracer = getattr(engine, "tracer", None)
        try:
            rep.supervisor.close()
            engine._release_device()
        except Exception:
            pass  # the teardown of a broken engine is best effort
        rep.draining = False
        rep.retired = True
        self.retired_replicas += 1
        if emit and tracer is not None and tracer.enabled:
            tracer.emit(EV_SCALE, None, action="retire", replica=rep.index,
                        live=self.live_replicas)

    @property
    def live_replicas(self) -> int:
        """Replicas not yet RETIRED (OK + DRAINING + DEAD)."""
        return sum(1 for rep in self.replicas if not rep.retired)

    # --- ids ---------------------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        """Handles ever created (retired ones included: stable indices)."""
        return len(self.replicas)

    def _cluster_rid_for(self, replica: int, engine_rid: int) -> int:
        """The cluster id of an engine id, minted at first sight (a
        supervisor's construction-time resume delivers outputs of requests
        this cluster never submitted: they get fresh ids)."""
        key = (replica, engine_rid)
        rid = self._by_engine.get(key)
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
            self._by_engine[key] = rid
            self._routes[rid] = key
        return rid

    def _bind(self, cluster_rid: int, replica: int, engine_rid: int) -> None:
        self._routes[cluster_rid] = (replica, engine_rid)
        self._by_engine[(replica, engine_rid)] = cluster_rid

    def placement(self, cluster_rid: int) -> tuple[int, int] | None:
        """(replica index, engine rid) serving a cluster id now."""
        return self._routes.get(cluster_rid)

    # --- routing -----------------------------------------------------------------
    def _eligible(self, request: Request, *, resumed: bool) -> list[ReplicaHandle]:
        """Health- and role-gated candidates: never an unhealthy, draining or
        retired replica, never one whose brownout would shed this priority.
        A replica whose last step ran long (``stalled``) is only avoided:
        when every live replica looks stalled the work still places. Fresh
        admissions need prefill capability, continuations prefer decode
        capability (falling back rather than stranding work)."""
        alive: list[ReplicaHandle] = []
        calm: list[ReplicaHandle] = []
        for rep in self.replicas:
            sup = rep.supervisor
            if rep.retired or rep.draining or sup.unhealthy:
                continue
            if sup.brownout_level > 0 and request.priority < sup.brownout_level:
                continue
            alive.append(rep)
            if not sup.heartbeat()["stalled"]:
                calm.append(rep)
        healthy = calm if calm else alive
        want = ROLE_DECODE if resumed else ROLE_PREFILL
        preferred = [r for r in healthy if r.role in (ROLE_MIXED, want)]
        return preferred if preferred else healthy

    def _rank(self, request: Request, candidates: list[ReplicaHandle], *,
              resumed: bool) -> list[ReplicaHandle]:
        """Preference order under the policy. Prefix placement probes each
        candidate's trie with `PrefixCache.match_len` and prefers the longest
        holder, then the least load (queue depth + active slots), then the
        lowest index. Round robin, and every continuation (which never reads
        the cache: `scheduler._run_key`), rotate from the cursor."""
        if not candidates:
            return []
        if self.config.policy == POLICY_ROUND_ROBIN or resumed:
            start = self._rr
            self._rr += 1
            rotated = [candidates[(start + j) % len(candidates)] for j in range(len(candidates))]
            self._last_rank = {rep.index: {"match_len": 0} for rep in rotated}
            return rotated
        scored = []
        self._last_rank = {}
        for rep in candidates:
            cache = getattr(rep.engine, "prefix_cache", None)
            match = (cache.match_len(request.prompt)
                     if cache is not None and request.cache_prefix else 0)
            load = rep.engine.scheduler.queue_depth + rep.engine.active_slots
            self._last_rank[rep.index] = {"match_len": match, "load": load}
            scored.append((-match, load, rep.index, rep))
        scored.sort(key=lambda t: t[:3])
        if -scored[0][0] > 0:
            self._route_match_tokens += -scored[0][0]
        return [t[3] for t in scored]

    # --- serving -----------------------------------------------------------------
    def submit(self, request: Request | Any, params: SamplingParams | None = None) -> SubmitResult:
        """Route and admit. The `SubmitResult` carries a cluster request id;
        a rejection carries the most specific reason the router saw (every
        replica dead: ``unhealthy``; all shedding: ``overload``; else the
        last replica's own verdict)."""
        if not isinstance(request, Request):
            request = Request(prompt=list(request), params=params or SamplingParams())
        return self._place(request, resumed=False)

    def _place(self, request: Request, *, resumed: bool) -> SubmitResult:
        candidates = self._rank(request, self._eligible(request, resumed=resumed),
                                resumed=resumed)
        if not candidates:
            if all(rep.supervisor.unhealthy for rep in self.replicas):
                return SubmitResult(False, None, REJECT_UNHEALTHY, "every replica is unhealthy")
            return SubmitResult(False, None, REJECT_OVERLOAD,
                                "every healthy replica is shedding load")
        last: SubmitResult | None = None
        for rank, rep in enumerate(candidates):
            result = rep.supervisor.submit(request)
            if not result.accepted:
                last = result
                continue
            rid = self._next_rid
            self._next_rid += 1
            self._bind(rid, rep.index, result.request_id)
            self._routed[POLICY_ROUND_ROBIN if resumed else self.config.policy] += 1
            tracer = getattr(rep.engine, "tracer", None)
            if tracer is not None and tracer.enabled:
                # why it won: "fallback:" marks a placement that fell through
                # earlier-ranked replicas' rejections
                match_len = int(self._last_rank.get(rep.index, {}).get("match_len", 0))
                if resumed:
                    reason = "resumed"
                elif self.config.policy == POLICY_ROUND_ROBIN:
                    reason = "round_robin"
                elif match_len > 0:
                    reason = "prefix_match"
                else:
                    reason = "load_tiebreak"
                if rank > 0:
                    reason = f"fallback:{reason}"
                tracer.emit(EV_ROUTE, result.request_id, replica=rep.index,
                            policy=self.config.policy, resumed=resumed,
                            candidates=len(candidates), match_len=match_len, reason=reason)
            return SubmitResult(True, rid)
        return SubmitResult(False, None, last.reason, last.detail)

    def _translate(self, replica: int, outputs: list[RequestOutput]) -> list[RequestOutput]:
        """Engine-id outputs -> cluster-id outputs, delivery recorded."""
        out = []
        for o in outputs:
            rid = self._cluster_rid_for(replica, o.request_id)
            self._delivered.add(rid)
            out.append(dataclasses.replace(o, request_id=rid))
        return out

    def step(self) -> list[RequestOutput]:
        """One cluster step: step every healthy replica with work (DRAINING
        ones too, so their work finishes), translate ids, and when a
        replica's restart budget was just spent migrate its backlog before
        returning, so the caller never sees ``rejected:unhealthy`` for work
        another replica can finish. A DRAINING replica retires once idle (or
        dead: its backlog just migrated). An attached `FleetAutoscaler` then
        runs one evaluation."""
        outputs: list[RequestOutput] = self._pending_outputs
        self._pending_outputs = []
        for rep in self.replicas:
            if rep.retired:
                continue
            sup = rep.supervisor
            if not sup.unhealthy and sup.has_work:
                try:
                    produced = sup.step()
                except EngineUnhealthyError:
                    produced = []
                if sup.unhealthy and self.config.migrate:
                    produced = self._migrate(rep, produced)
                    rep.migrated = True
                outputs.extend(self._translate(rep.index, produced))
            if rep.draining and (sup.unhealthy or not sup.has_work):
                self._finalize_retire(rep)
        if self.autoscaler is not None:
            outputs.extend(self.autoscaler.evaluate())
        return outputs

    @property
    def has_work(self) -> bool:
        return bool(self._pending_outputs) or any(
            rep.healthy and rep.supervisor.has_work for rep in self.replicas)

    def drain(self, max_steps: int | None = None) -> list[RequestOutput]:
        """Graceful shutdown: stop admissions everywhere, then step
        (migrating as needed) until idle, at most ``max_steps`` steps."""
        for rep in self.replicas:
            if rep.healthy:
                rep.engine.begin_drain()
        outputs: list[RequestOutput] = []
        steps = 0
        try:
            while self.has_work:
                outputs.extend(self.step())
                steps += 1
                if max_steps is not None and steps >= max_steps and self.has_work:
                    for rep in self.replicas:
                        if rep.healthy:
                            outputs.extend(self._translate(rep.index, rep.engine.abort_all()))
                    break
        finally:
            for rep in self.replicas:
                if rep.healthy:
                    rep.engine.end_drain()
        return outputs

    def close(self) -> None:
        for rep in self.replicas:
            rep.supervisor.close()

    # --- migration ---------------------------------------------------------------
    def _migrate(self, dead: ReplicaHandle, produced: list[RequestOutput]) -> list[RequestOutput]:
        """Journal-backed migration off a failed replica (module docstring).

        ``produced`` is the dying step's output, the supervisor's fail-loud
        accounting (every request in flight ``rejected:unhealthy`` with its
        partial stream). The journal supersedes it: requests that really
        finished are delivered (from the journal when their terminal never
        reached the caller), and every other accepted request is resubmitted
        to a healthy replica with its emitted tokens as ``resume_tokens``.
        Only a request no healthy replica takes falls back to the fail-loud
        output: none is ever dropped."""
        self.migrations += 1
        try:
            scan = RequestJournal.scan(dead.journal_path)
        except Exception:
            # no readable journal: nothing better than the supervisor's own
            # accounting
            return produced
        deliver = [o for o in produced if o.finish_reason != _UNHEALTHY_REASON]
        fallback = {o.request_id: o for o in produced if o.finish_reason == _UNHEALTHY_REASON}
        now = self._clock()
        for erid, (reason, toks) in scan.finishes.items():
            if reason == _UNHEALTHY_REASON:
                continue
            rid = self._by_engine.get((dead.index, erid))
            if rid is not None and rid in self._delivered:
                continue
            sub = scan.submits.get(erid, {})
            deliver.append(RequestOutput(request_id=erid, prompt_len=len(sub.get("prompt", ())),
                                         tokens=list(toks), finish_reason=reason,
                                         finish_time=now))
        # every accepted request without a real terminal: admitted ones first
        # (admission order), then queued ones (submit order), the resume
        # replay's order
        def unfinished(erid: int) -> bool:
            return scan.finishes.get(erid, (_UNHEALTHY_REASON,))[0] == _UNHEALTHY_REASON

        candidates = [erid for erid in scan.admit_order if unfinished(erid)]
        seen = set(candidates)
        candidates += [erid for erid in scan.submits if erid not in seen and unfinished(erid)]
        for erid in candidates:
            out = self._migrate_one(dead, scan, erid, fallback.get(erid))
            if out is not None:
                deliver.append(out)
        return deliver

    def _migrate_one(self, dead: ReplicaHandle, scan: Any, erid: int,
                     fallback: RequestOutput | None) -> RequestOutput | None:
        """Rebuild one request from its journal identity and place it on a
        healthy replica. Returns an output to deliver now (its stream is
        complete, or nobody takes it); None when it is live elsewhere."""
        sub = scan.submits[erid]
        prompt = [int(t) for t in sub["prompt"]]
        sp = SamplingParams(temperature=float(sub["params"]["temperature"]),
                            top_k=sub["params"]["top_k"], seed=int(sub["params"]["seed"]),
                            max_new_tokens=int(sub["params"]["max_new_tokens"]))
        if erid in scan.finishes:  # the abort record carries the whole stream
            toks = list(scan.finishes[erid][1])
        else:
            toks = list(scan.tokens.get(erid, []))
        admitted = erid in scan.admit_order
        cluster_rid = self._cluster_rid_for(dead.index, erid)
        # as resume() does: a stream at its budget or its EOS completes here
        target = next((r for r in self.replicas if r.accepting), None)
        done_reason = None
        eos = target.engine.eos_token_id if target is not None else None
        budget = sp.max_new_tokens
        if target is not None:
            budget = min(budget, target.engine.max_len - len(prompt))
        if eos is not None and eos in toks:
            toks = toks[:toks.index(eos) + 1]
            done_reason = FINISH_EOS
        elif len(toks) >= budget > 0:
            toks = toks[:budget]
            done_reason = FINISH_LENGTH
        if done_reason is not None:
            self._delivered.add(cluster_rid)
            return RequestOutput(request_id=erid, prompt_len=len(prompt), tokens=toks,
                                 finish_reason=done_reason, finish_time=self._clock())
        keep = len(toks)
        if target is not None:
            # the continuation must fit a prompt bucket: keep the longest
            # prefix that fits and decode the rest again (seeded, so the
            # stream is unchanged: resume()'s rule)
            keep = max(0, min(keep, target.engine.scheduler.max_prompt_len - len(prompt)))
        request = Request(
            prompt=prompt, params=sp,
            # an admitted request's queue-wait deadline was spent before the
            # replica died; keeping it would expire the stream at once
            deadline_s=None if admitted else sub.get("deadline_s"),
            cache_prefix=bool(sub.get("cache_prefix", True)),
            priority=int(sub.get("priority", 0)), tenant=str(sub.get("tenant", "")),
            resume_tokens=toks[:keep])
        result = self._place(request, resumed=True)
        if not result.accepted:
            # nobody takes it: account for it loudly, never drop it
            self._delivered.add(cluster_rid)
            if fallback is not None:
                return fallback
            return RequestOutput(request_id=erid, prompt_len=len(prompt), tokens=toks,
                                 finish_reason=_UNHEALTHY_REASON, finish_time=self._clock())
        # _place minted a cluster id for the new engine id: fold it back
        # onto the request's own
        new_key = self._routes.pop(result.request_id)
        if result.request_id == self._next_rid - 1:
            self._next_rid -= 1
        self._bind(cluster_rid, *new_key)
        self.migrated_requests += 1
        rep = self.replicas[new_key[0]]
        # the target's journal has the submit (write-ahead) but not the
        # resumed prefix: journal it, so the next crash finds it there
        if request.resume_tokens and rep.engine.journal is not None:
            rep.engine.journal.log_progress(new_key[1], list(request.resume_tokens),
                                            len(request.resume_tokens))
        tracer = getattr(rep.engine, "tracer", None)
        if tracer is not None and tracer.enabled:
            tracer.emit(EV_MIGRATE, new_key[1], from_replica=dead.index, to_replica=rep.index,
                        resumed=len(request.resume_tokens))
        return None

    # --- telemetry ---------------------------------------------------------------
    def heartbeat(self) -> dict[str, Any]:
        """The cluster's health: each live replica's supervisor heartbeat
        with its index, role and state, and the counts the router admits
        against."""
        rows = []
        for rep in self.replicas:
            if rep.retired:
                continue
            hb = rep.supervisor.heartbeat()
            hb["replica"] = rep.index
            hb["role"] = rep.role
            hb["state"] = rep.state
            rows.append(hb)
        return {
            "replicas": rows,
            "healthy": sum(1 for rep in self.replicas if rep.healthy),
            "unhealthy": sum(1 for rep in self.replicas if not rep.retired and not rep.healthy),
            "draining": sum(1 for rep in self.replicas if not rep.retired and rep.draining),
            "retired": self.retired_replicas,
            "migrations": self.migrations,
        }

    def router_stats(self) -> dict[str, Any]:
        """The ``cluster/*`` gauges (`ServingMetrics.snapshot`'s shape)."""
        return {
            "cluster/replicas": self.live_replicas,
            "cluster/healthy_replicas": sum(1 for rep in self.replicas if rep.healthy),
            "cluster/draining_replicas": sum(1 for rep in self.replicas
                                             if not rep.retired and rep.draining),
            "cluster/retired_replicas": self.retired_replicas,
            "cluster/replaced_replicas": self.replaced_replicas,
            "cluster/migrations": self.migrations,
            "cluster/migrated_requests": self.migrated_requests,
            "cluster/routed_prefix": self._routed[POLICY_PREFIX],
            "cluster/routed_round_robin": self._routed[POLICY_ROUND_ROBIN],
            "cluster/route_match_tokens": self._route_match_tokens,
        }

    def memory_stats(self) -> dict[str, Any]:
        """The sum of every healthy replica's numeric `memory_stats` (each
        replica's own is exported under ``replica<i>/serving/mem/``)."""
        totals: dict[str, Any] = {}
        for rep in self.replicas:
            if not rep.healthy:
                continue
            for k, v in rep.engine.memory_stats().items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                totals[k] = totals.get(k, 0) + v
        return totals

    # headroom keys a sum would misstate: the best replica's slot wait is the
    # cluster's admission wait (the router sends work there), and the slowest
    # replica to run out bounds the cluster's runway
    _HEADROOM_MIN = frozenset({"est_slot_free_s"})
    _HEADROOM_MAX = frozenset({"seconds_to_exhaustion"})

    def capacity_headroom(self) -> dict[str, Any]:
        """The accepting replicas' headroom: additive gauges sum,
        ``est_slot_free_s`` takes the min and ``seconds_to_exhaustion`` the
        max. A draining replica's free slots are no admission capacity."""
        totals: dict[str, Any] = {}
        for rep in self.replicas:
            if not rep.accepting:
                continue
            for k, v in rep.engine.capacity_headroom().items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                if k in self._HEADROOM_MIN:
                    totals[k] = v if k not in totals else min(totals[k], v)
                elif k in self._HEADROOM_MAX:
                    totals[k] = v if k not in totals else max(totals[k], v)
                else:
                    totals[k] = totals.get(k, 0) + v
        return totals

    def replica_samples(self) -> list[tuple[int, dict[str, Any]]]:
        """``(stable index, gauges)`` per live replica, for the telemetry
        exporter's ``replica<i>/`` namespace (`TelemetryExporter.sample`):
        its metrics snapshot, memory and headroom gauges, class gauges, and
        its health as the cluster sees it. RETIRED replicas are skipped: they
        stop emitting rather than renumbering, so a series keeps its index
        across retire and replace."""
        samples: list[tuple[int, dict[str, Any]]] = []
        for rep in self.replicas:
            if rep.retired:
                continue
            gauges: dict[str, Any] = dict(rep.metrics.snapshot())
            if rep.healthy:
                for k, v in rep.engine.memory_stats().items():
                    gauges[f"serving/mem/{k}"] = v
                for k, v in rep.engine.capacity_headroom().items():
                    gauges[f"serving/headroom/{k}"] = v
                class_gauges = getattr(rep.engine.scheduler, "class_gauges", None)
                if callable(class_gauges):
                    gauges.update(class_gauges())
            hb = rep.supervisor.heartbeat()
            gauges["cluster/healthy"] = int(rep.healthy)
            gauges["cluster/draining"] = int(rep.draining)
            gauges["cluster/state"] = rep.state
            gauges["cluster/brownout_level"] = hb["brownout_level"]
            gauges["cluster/restarts"] = hb["restarts"]
            gauges["cluster/role"] = rep.role
            samples.append((rep.index, gauges))
        return samples
