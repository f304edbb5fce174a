"""Joint design-space explorer: pipeline x datapath x block shapes as ONE
optimization problem, on the card.

Counterpart of `repro/netgen/explore.py`: the same space, strategies
(the same seeded numpy draws, so a search over a space of the same
shape walks the same candidates in the same order), objectives, record
layout and telemetry. What differs is the card: candidates are `cuda`
targets with Hopper's block shapes (`bm`, `bn`; no port kernel blocks
K, so there is no `bkw` axis), measured on the session's device, and
the winner is published under the `cuda-explored` key, keyed on the
CUDA device's name and compute capability.

The paper's core claim is that the *combination* of optimizations buys
inference speed — yet the stack historically tuned each lever in
isolation: `KernelTuner` grid-searched tile sizes under a fixed
pipeline, the `cost` target priced Fig-7 logic cells after the fact,
and `PipelineSpec` exposed pass selection and CSE budgets nobody
searched over. This module closes the loop (ROADMAP item 2), in the
spirit of the FPGA DSE literature where accelerator design IS a joint
knob sweep:

  SearchSpace — the candidate axes: pipeline spec strings (pass
      selection, CSE budget/bucketing), plan form / datapath (dense /
      packed / planes / fusednet), kernel block shapes (bm, bn),
      and optionally several nets at once (the ladder-depth sweep:
      accuracy-vs-cells across net depths). The cartesian product is
      the space; strategies sample it.

  Explorer — the seeded, deterministic search driver. Strategies:
      "random" (a seeded permutation of the product, first `budget`
      unique candidates) and "anneal" (simulated annealing: one-axis
      neighbor moves, relative-delta Metropolis acceptance, geometric
      temperature decay). Candidates are pruned BEFORE any measurement
      by the shared legality machinery: a pipeline whose optimized
      circuit has no layer-structured ExecutionPlan
      (`IrregularCircuitError` — CSE'd sharing) cannot back a
      predictor, and tile candidates go through
      `repro_torch.netgen.analysis.tile_legality` (non-positive blocks,
      shapes or shared memory a kernel refuses, duplicate launches). Every
      measured candidate is compiled through `Session.compile`, so
      artifacts land in the `ArtifactStore` and a re-evaluated
      configuration never recompiles.

  Objective — pluggable, lower-is-better: "latency" (measured wall
      clock of the compiled predictor on a fixed batch, best-of-reps),
      "cells" (the Fig-7 logic-cell estimate every Artifact carries —
      fully deterministic, and the only objective that admits
      irregular/CSE'd pipelines, which the FPGA flow can still emit),
      "combined" (us + cells_weight * cells), or any callable over the
      per-candidate `Evaluation` via `make_objective`.

  ExplorationReport — per-candidate objective values, the acceptance
      trace, the prune log with reasons, and the winner as a
      `(PipelineSpec, target)` pair ready for `Session.compile`.

Persistence mirrors the autotuner: the whole search result (winner +
measurement table + trace) is one content-addressed `TuneRecord`
(keyed on net digests, space, objective, strategy, budget, seed,
device kind) written through `KernelTuner.get_or_run`, so a second
process with the same `TuneStore` replays the exploration with ZERO
measurements — and, because artifacts persisted too, zero compiles.
The winner's datapath additionally publishes under the
`cuda-explored` key (`backends.cuda.publish_explored`), which is
what `cuda[explored=true]` — and the serving layer's stacked
dispatch — resolve per plan signature.

Telemetry (scope per explorer): `netgen_explore_candidates_total` ==
`..._pruned_total` + `..._measured_total`, and every measured
candidate backs exactly one artifact (`..._artifacts_total`) — the
identities `benchmarks/check_trace.py` gates CI on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import numpy as np

from repro_torch.netgen import telemetry
from repro_torch.netgen.backends.cuda import _TUNE_BLOCKS
from repro_torch.netgen.graph import IrregularCircuitError
from repro_torch.netgen.pipeline import PipelineSpec
from repro_torch.netgen.plan import lower_circuit
from repro_torch.netgen.targets import resolve_target, target_string

__all__ = [
    "Candidate", "Evaluation", "ExplorationReport", "Explorer",
    "Objective", "SearchSpace", "make_objective",
]

_STRATEGIES = ("random", "anneal")

# Default pipeline axis: the executable ladder (prune only; prune +
# selected addends) plus CSE'd variants — which only the cells
# objective can evaluate (no ExecutionPlan lowers from shared
# sub-circuits; predictor objectives prune them with the reason).
_DEFAULT_PIPELINES = (
    "default",                               # zeros,prune
    "zeros,prune,addends",
    "zeros,prune,addends,cse[bucketed=true]",
)
_DEFAULT_FORMS = ("dense", "packed", "planes", "fusednet")
# Hopper's block shapes, the tuner's grid (`backends/cuda.py`); as many as
# the reference's TPU tiles, so the default spaces are the same size.
_DEFAULT_TILES = _TUNE_BLOCKS


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the joint space. `net` names an entry of the
    explorer's nets mapping (the ladder-depth axis; "net" for the
    common single-net case)."""
    pipeline: str
    form: str
    bm: int
    bn: int
    net: str = "net"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def target(self) -> str:
        """The canonical cuda target string this candidate compiles
        under (form pinned via its flag, blocks pinned explicitly)."""
        opts: dict = {"bm": self.bm, "bn": self.bn}
        if self.form != "dense":
            opts[self.form] = True
        tgt, opts = resolve_target("cuda", opts)
        return target_string(tgt, opts)

    @classmethod
    def from_dict(cls, d: Mapping) -> "Candidate":
        return cls(pipeline=d["pipeline"], form=d["form"], bm=int(d["bm"]),
                   bn=int(d["bn"]), net=d.get("net", "net"))


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """The candidate axes (see module doc). `pipelines` are spec
    strings `PipelineSpec.coerce` accepts; `tiles` are bm/bn dicts;
    `nets` are names into the explorer's nets mapping."""
    pipelines: tuple = _DEFAULT_PIPELINES
    forms: tuple = _DEFAULT_FORMS
    tiles: tuple = _DEFAULT_TILES
    nets: tuple = ("net",)

    def __post_init__(self):
        if not (self.pipelines and self.forms and self.tiles and self.nets):
            raise ValueError("every SearchSpace axis needs >= 1 entry")
        for form in self.forms:
            if form not in _DEFAULT_FORMS:
                raise ValueError(f"unknown datapath form {form!r} "
                                 f"(expected one of {_DEFAULT_FORMS})")

    def candidates(self) -> list[Candidate]:
        """The full cartesian product, canonical order (net, pipeline,
        form, tiles) — the order strategies permute deterministically."""
        out = []
        for net in self.nets:
            for pipe in self.pipelines:
                spec = PipelineSpec.coerce(pipe).spec_string()
                for form in self.forms:
                    for tile in self.tiles:
                        out.append(Candidate(
                            pipeline=spec, form=form, bm=int(tile["bm"]),
                            bn=int(tile["bn"]), net=net))
        return out

    def as_fields(self) -> dict:
        """JSON-stable identity for the exploration record key."""
        return {
            "pipelines": [PipelineSpec.coerce(p).spec_string()
                          for p in self.pipelines],
            "forms": list(self.forms),
            "tiles": [dict(t) for t in self.tiles],
            "nets": list(self.nets),
        }


@dataclasses.dataclass
class Evaluation:
    """What one measured candidate produced — the objective callable's
    input. `us` is None unless the objective declared needs_latency;
    `artifact` is the compiled predictor Artifact (or the cost-report
    Artifact for non-predictor objectives)."""
    candidate: Candidate
    cells: int
    us: float | None
    artifact: object


@dataclasses.dataclass(frozen=True)
class Objective:
    """Lower-is-better scoring of an Evaluation. `needs_predictor`
    prunes irregular (CSE'd) pipelines pre-measurement and enforces
    tile legality; `needs_latency` additionally times the predictor."""
    name: str
    fn: Callable[[Evaluation], float]
    needs_predictor: bool = True
    needs_latency: bool = True


def make_objective(fn: Callable[[Evaluation], float], *, name: str,
                   needs_predictor: bool = True,
                   needs_latency: bool = True) -> Objective:
    """Wrap a callable objective. `name` is part of the exploration
    record's content address — it must identify the scoring semantics
    (two different callables under one name would replay each other's
    records)."""
    return Objective(name=name, fn=fn, needs_predictor=needs_predictor,
                     needs_latency=needs_latency)


def _resolve_objective(objective, cells_weight: float) -> Objective:
    if isinstance(objective, Objective):
        return objective
    if callable(objective):
        name = getattr(objective, "__name__", None)
        if not name or name == "<lambda>":
            raise ValueError(
                "callable objectives need a stable name — use "
                "make_objective(fn, name=...)")
        return make_objective(objective, name=name)
    if objective == "latency":
        return Objective("latency", lambda ev: float(ev.us))
    if objective == "cells":
        return Objective("cells", lambda ev: float(ev.cells),
                         needs_predictor=False, needs_latency=False)
    if objective == "combined":
        return Objective(
            f"combined[cells_weight={cells_weight}]",
            lambda ev: float(ev.us) + cells_weight * float(ev.cells))
    raise ValueError(f"unknown objective {objective!r} (expected "
                     f"'latency', 'cells', 'combined', or an Objective)")


@dataclasses.dataclass
class ExplorationReport:
    """The search result, replayable from its persisted record.
    `evaluations` is the ((candidate dict, value), ...) table in search
    order; `trace` the per-step acceptance log; `pruned` the
    ((candidate dict, reason), ...) rejections; `source` says whether
    this process searched ("search") or replayed ("memory"/"store")."""
    best: Candidate
    best_value: float
    objective: str
    strategy: str
    budget: int
    seed: int
    evaluations: tuple
    trace: tuple
    pruned: tuple
    source: str
    key: str
    device_kind: str

    @property
    def candidates(self) -> int:
        return len(self.evaluations) + len(self.pruned)

    def best_config(self) -> tuple[PipelineSpec, str]:
        """The winner as the `(PipelineSpec, target)` pair
        `Session.compile(net, target=t, pipeline=spec)` takes — the
        spec object plus the canonical cuda target string with the
        winning form and block shapes pinned."""
        return (PipelineSpec.coerce(self.best.pipeline),
                self.best.target())

    def as_dict(self) -> dict:
        return {
            "best": self.best.as_dict(),
            "best_value": self.best_value,
            "objective": self.objective,
            "strategy": self.strategy,
            "budget": self.budget,
            "seed": self.seed,
            "evaluations": [[c, v] for c, v in self.evaluations],
            "trace": [dict(t) for t in self.trace],
            "pruned": [[c, r] for c, r in self.pruned],
            "source": self.source,
            "key": self.key,
            "device_kind": self.device_kind,
        }

    def describe(self) -> str:
        spec, tgt = self.best_config()
        return (f"explore[{self.strategy}/{self.objective}] "
                f"{self.candidates} candidates ({len(self.pruned)} pruned, "
                f"{len(self.evaluations)} measured, source={self.source}) "
                f"-> {tgt} under '{spec.spec_string()}' "
                f"(value {self.best_value:.3f})")


class _Base:
    """Per-(net, pipeline) evaluation context, built lazily ONCE: the
    optimized circuit (via the session's cost target — an Artifact, so
    it lands in the store), its cells, and the lowered plan or the
    irregularity reason. The tile-legality closure is stateful on
    purpose: clamp-duplicate detection spans all candidates that share
    this plan."""

    def __init__(self, session, net, pipeline: str, batch: int,
                 input_threshold):
        from repro_torch.netgen.analysis import tile_legality

        self.artifact = session.compile(
            net, target="cost", pipeline=pipeline,
            input_threshold=input_threshold)
        self.cells = int(self.artifact.cost.total)
        self.plan = None
        self.irregular: str | None = None
        try:
            self.plan = lower_circuit(self.artifact.circuit)
            self._legal = tile_legality(self.plan, batch=batch)
        except IrregularCircuitError as e:
            self.irregular = f"no ExecutionPlan for this pipeline: {e}"

    def tile_reason(self, cand: Candidate) -> str | None:
        if self.irregular is not None:
            return self.irregular
        return self._legal({"form": cand.form, "bm": cand.bm,
                            "bn": cand.bn})


class Explorer:
    """The seeded joint-search driver (see module doc). Construct with
    a `Session` (its store/tuner give the zero-compile/zero-measurement
    replay) and run(); or use `Session.explore(...)`."""

    def __init__(self, session, *, net=None, nets: Mapping | None = None,
                 space: SearchSpace | None = None, objective="latency",
                 strategy: str = "anneal", budget: int = 24, seed: int = 0,
                 batch: int = 256, reps: int = 2, cells_weight: float = 0.01,
                 input_threshold=None):
        from repro_torch.core.quantize import weights_digest
        from repro_torch.netgen.frontend import _extract_weights
        from repro_torch.netgen.tune import default_tuner

        if (net is None) == (nets is None):
            raise ValueError("pass net= or nets=, not both / neither")
        self.session = session
        self.nets = dict(nets) if nets is not None else {"net": net}
        self.space = space if space is not None else SearchSpace(
            nets=tuple(self.nets))
        missing = [n for n in self.space.nets if n not in self.nets]
        if missing:
            raise ValueError(f"space names unknown nets: {missing}")
        if strategy not in _STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r} "
                             f"(expected one of {_STRATEGIES})")
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        self.objective = _resolve_objective(objective, cells_weight)
        self.strategy = strategy
        self.budget = int(budget)
        self.seed = int(seed)
        self.batch = int(batch)
        self.reps = max(1, int(reps))
        self.input_threshold = input_threshold
        self.tuner = session.tuner if session.tuner is not None \
            else default_tuner()
        # content identity of each net (compile-free)
        self._digests = {}
        for name in self.space.nets:
            ws, thr = _extract_weights(self.nets[name], input_threshold)
            self._digests[name] = weights_digest(ws, thr)
        self._bases: dict[tuple, _Base] = {}
        self._tel = telemetry.get_registry()
        self._scope = telemetry.new_scope("explorer")
        mk = lambda n: self._tel.counter(n, explorer=self._scope)  # noqa: E731
        self._c_candidates = mk("netgen_explore_candidates_total")
        self._c_pruned = mk("netgen_explore_pruned_total")
        self._c_measured = mk("netgen_explore_measured_total")
        self._c_accepted = mk("netgen_explore_accepted_total")
        self._c_artifacts = mk("netgen_explore_artifacts_total")
        self._c_replays = mk("netgen_explore_replays_total")

    # -- evaluation ----------------------------------------------------------

    def _base(self, cand: Candidate) -> _Base:
        key = (cand.net, cand.pipeline)
        base = self._bases.get(key)
        if base is None:
            base = _Base(self.session, self.nets[cand.net], cand.pipeline,
                         self.batch, self.input_threshold)
            self._bases[key] = base
        return base

    def _prune_reason(self, cand: Candidate, base: _Base) -> str | None:
        """Pre-measurement legality through the shared analysis checks.
        Objectives that never build a predictor (cells) skip both — an
        irregular circuit still has a cell price and tile sizes are
        moot — but still dedupe identical evaluations."""
        if self.objective.needs_predictor:
            return base.tile_reason(cand)
        # cells-only: every candidate of one (net, pipeline) evaluates
        # to the same number; measuring it once is enough
        first = getattr(base, "_cells_claimed", None)
        if first is not None and first != cand:
            return (f"same cells evaluation as {first.as_dict()} — "
                    f"datapath/tiles do not move the cells objective")
        base._cells_claimed = cand
        return None

    def _measure_us(self, artifact, n_inputs: int) -> float:
        """Best of `reps` host-clock calls after one untimed warmup, the
        answers copied to the host so the device has finished."""
        import time

        x = np.zeros((self.batch, n_inputs), np.uint8)
        artifact(x).cpu()                        # warmup (first launch)
        best = math.inf
        for _ in range(self.reps):
            t0 = time.perf_counter()
            artifact(x).cpu()
            best = min(best, time.perf_counter() - t0)
        return best * 1e6

    def _evaluate(self, cand: Candidate, base: _Base) -> float:
        """Objective value for one legal candidate. The compile flows
        through `Session.compile` (memory tier -> ArtifactStore ->
        compile_resolved), so re-evaluations and warm processes never
        rebuild."""
        artifact = base.artifact
        us = None
        if self.objective.needs_predictor:
            artifact = self.session.compile(
                self.nets[cand.net], target=cand.target(),
                pipeline=cand.pipeline,
                input_threshold=self.input_threshold)
            if self.objective.needs_latency:
                us = self._measure_us(artifact, artifact.circuit.n_inputs)
        value = float(self.objective.fn(Evaluation(
            candidate=cand, cells=base.cells, us=us, artifact=artifact)))
        if not math.isfinite(value):
            raise ValueError(
                f"objective {self.objective.name!r} returned {value!r} "
                f"for {cand.as_dict()}")
        return value

    def _consider(self, cand: Candidate, state: dict):
        """Evaluate one not-yet-seen candidate: returns (value, reason)
        with exactly one of the two set, and keeps every counter
        identity (candidates == pruned + measured; artifacts ==
        measured) exact."""
        self._c_candidates.inc()
        base = self._base(cand)
        reason = self._prune_reason(cand, base)
        if reason is None:
            try:
                value = self._evaluate(cand, base)
            except (IrregularCircuitError, ValueError) as e:
                reason = f"build failed: {e}"
        if reason is not None:
            self._c_pruned.inc()
            state["pruned"].append((cand.as_dict(), reason))
            state["values"][cand] = (math.inf, reason)
            return math.inf, reason
        self._c_measured.inc()
        self._c_artifacts.inc()          # the artifact backing this value
        state["evals"].append((cand.as_dict(), value))
        state["values"][cand] = (value, None)
        return value, None

    # -- strategies ----------------------------------------------------------

    def _search(self) -> dict:
        rng = np.random.default_rng(self.seed)
        pool = self.space.candidates()
        state: dict = {"evals": [], "pruned": [], "values": {}, "trace": []}
        if self.strategy == "random":
            self._random(rng, pool, state)
        else:
            self._anneal(rng, pool, state)
        if not state["evals"]:
            first = state["pruned"][0][1] if state["pruned"] else "no steps"
            raise ValueError(
                f"exploration measured nothing within budget "
                f"{self.budget} (first prune: {first})")
        return state

    def _trace(self, state, step, cand, value, reason, accepted, best):
        state["trace"].append({
            "step": step, "candidate": cand.as_dict(),
            "value": None if reason is not None else value,
            "pruned": reason, "accepted": bool(accepted),
            "best": None if not math.isfinite(best) else best})
        if accepted:
            self._c_accepted.inc()

    def _random(self, rng, pool, state) -> None:
        """Seeded permutation of the product; first `budget` candidates.
        Acceptance == new incumbent."""
        best = math.inf
        order = rng.permutation(len(pool))
        for step, idx in enumerate(order[:self.budget]):
            cand = pool[idx]
            value, reason = self._consider(cand, state)
            accepted = reason is None and value < best
            best = min(best, value)
            self._trace(state, step, cand, value, reason, accepted, best)

    def _anneal(self, rng, pool, state) -> None:
        """Simulated annealing over the joint space: neighbor = one axis
        re-drawn; Metropolis acceptance on the RELATIVE objective delta
        (latency us and logic cells live on different scales);
        geometric cooling sized to the budget. A pruned proposal spends
        budget (it was considered) but never moves the state."""
        t0, t_end = 0.25, 0.01
        alpha = (t_end / t0) ** (1.0 / max(1, self.budget - 1))
        axes = ("pipeline", "form", "tiles", "net")
        cur = pool[int(rng.integers(len(pool)))]
        cur_v, reason = self._consider(cur, state)
        best = cur_v if reason is None else math.inf
        self._trace(state, 0, cur, cur_v, reason, reason is None, best)
        if reason is not None:
            cur = None                   # no incumbent yet
        temp = t0
        steps, proposals = 1, 0
        while steps < self.budget and proposals < self.budget * 32:
            proposals += 1
            temp *= alpha
            if cur is None:
                cand = pool[int(rng.integers(len(pool)))]
            else:
                cand = self._neighbor(cur, rng)
            prior = state["values"].get(cand)
            if prior is not None:
                # revisit: no budget spent, but an accepted re-walk is
                # a real state move
                value, reason = prior
                if reason is None and cur is not None \
                        and self._accept(value, cur_v, temp, rng):
                    cur, cur_v = cand, value
                continue
            value, reason = self._consider(cand, state)
            accepted = False
            if reason is None:
                if cur is None or self._accept(value, cur_v, temp, rng):
                    accepted = True
                    cur, cur_v = cand, value
            best = min(best, value if reason is None else math.inf)
            self._trace(state, steps, cand, value, reason, accepted, best)
            steps += 1

    def _accept(self, value: float, cur_v: float, temp: float, rng) -> bool:
        if value <= cur_v:
            return True
        rel = (value - cur_v) / max(abs(cur_v), 1e-9)
        return bool(rng.random() < math.exp(-rel / max(temp, 1e-9)))

    def _neighbor(self, cand: Candidate, rng) -> Candidate:
        axis = ("pipeline", "form", "tiles", "net")[int(rng.integers(4))]
        d = cand.as_dict()
        if axis == "pipeline":
            d["pipeline"] = PipelineSpec.coerce(self.space.pipelines[
                int(rng.integers(len(self.space.pipelines)))]).spec_string()
        elif axis == "form":
            d["form"] = self.space.forms[
                int(rng.integers(len(self.space.forms)))]
        elif axis == "net":
            d["net"] = self.space.nets[
                int(rng.integers(len(self.space.nets)))]
        else:
            d.update(self.space.tiles[
                int(rng.integers(len(self.space.tiles)))])
        return Candidate.from_dict(d)

    # -- the persisted problem ----------------------------------------------

    def key_fields(self) -> dict:
        from repro_torch.netgen.tune import device_kind

        return {
            "target": "netgen-explore",
            "device_kind": device_kind(self.session.device),
            "digests": self._digests,
            "space": self.space.as_fields(),
            "objective": self.objective.name,
            "strategy": self.strategy,
            "budget": self.budget,
            "seed": self.seed,
            "batch": self.batch,
            "reps": self.reps,
        }

    def run(self) -> ExplorationReport:
        """Search (or replay the persisted search) and return the
        report. Fresh searches publish the winner's datapath under the
        `cuda-explored` key so `cuda[explored=true]` and the
        serving layer resolve it by plan signature."""
        fields = self.key_fields()

        def _run(key: str):
            with self._tel.span(
                    "netgen.explore", explorer=self._scope,
                    strategy=self.strategy, objective=self.objective.name,
                    budget=self.budget, seed=self.seed) as sp:
                state = self._search()
                best_cand, best_value = min(
                    ((Candidate.from_dict(c), v) for c, v in state["evals"]),
                    key=lambda t: t[1])
                sp.set_attr("best", best_cand.as_dict())
                sp.set_attr("pruned", len(state["pruned"]))
                sp.set_attr("measured", len(state["evals"]))
            self._publish(best_cand, best_value, key)
            extra = {
                "trace": state["trace"],
                "pruned": [[c, r] for c, r in state["pruned"]],
                "objective": self.objective.name,
                "strategy": self.strategy,
                "budget": self.budget,
                "seed": self.seed,
            }
            return ({**best_cand.as_dict(), "value": best_value},
                    state["evals"], extra)

        rec, tier = self.tuner.get_or_run(fields, _run)
        if tier != "run":
            self._c_replays.inc()
        best = Candidate.from_dict(rec.best)
        return ExplorationReport(
            best=best,
            best_value=float(rec.best["value"]),
            objective=rec.extra.get("objective", self.objective.name),
            strategy=rec.extra.get("strategy", self.strategy),
            budget=int(rec.extra.get("budget", self.budget)),
            seed=int(rec.extra.get("seed", self.seed)),
            evaluations=tuple((dict(c), float(v))
                              for c, v in rec.measurements),
            trace=tuple(dict(t) for t in rec.extra.get("trace", ())),
            pruned=tuple((dict(c), r)
                         for c, r in rec.extra.get("pruned", ())),
            source="search" if tier == "run" else tier,
            key=rec.key,
            device_kind=fields["device_kind"],
        )

    def _publish(self, best: Candidate, value: float, key: str) -> None:
        """Winner -> `cuda-explored` datapath record (plan-signature
        keyed), unless the winning pipeline has no plan (a cells-only
        winner may be irregular — nothing executable to publish)."""
        from repro_torch.netgen.backends.cuda import publish_explored

        base = self._bases[(best.net, best.pipeline)]
        if base.plan is None:
            return
        publish_explored(
            base.plan, self.tuner,
            {"form": best.form, "bm": best.bm, "bn": best.bn},
            device=self.session.device,
            measurements=[({k: v for k, v in best.as_dict().items()},
                           value)],
            extra={"explore_key": key, "pipeline": best.pipeline,
                   "objective": self.objective.name})
