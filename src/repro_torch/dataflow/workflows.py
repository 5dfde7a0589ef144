"""The paper's four experiment workflows (§7.1, Fig. 14) as engine graphs.

  W1  tweets ⋈ slang-per-location  -> sink          (HashJoin skew, CA/TX)
  W2  sales ⋈ date_dim ⋈ item_dim  -> groupby item  (two joins, different skew)
  W3  orders -> range-sort on totalprice            (Sort skew, §7.10)
  W4  synthetic changing distribution ⋈ small table (§7.8)

``strategy`` selects the skew handler on the monitored operator(s):
``"none" | "flux" | "flowjoin" | "reshape"``.  ``device`` (default
``"cuda"``) is where the default ``"torch"`` exchange backend runs;
``partition_backend="numpy"`` selects the host plane.  Under the torch
backend ``device_executor`` (see :class:`~repro_torch.dataflow.engine.Engine`)
keeps the per-chunk exchange on every edge (``"host"``, the default) or
puts every eligible edge on the device-resident plane (``"jit"``), where
the engine fuses routing-equivalent edges unless ``REPRO_DEVICE_CHAIN=0``,
and ``device_budget`` arms the spill tier.
``reference=True`` builds the graph on the tuple-at-a-time oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.controller import ReshapeController
from ..core.types import ReshapeConfig, TransferMode
from . import datasets
from .baselines import FlowJoinController, FluxController
from .engine import Edge, Engine, Source
from .operators import Filter, GroupByAgg, HashJoinProbe, Operator, Project, RangeSort, Sink


def _engine(reference: bool, partition_backend, batch_ticks: int, device,
            device_executor, device_budget) -> Engine:
    return Engine(partition_backend=partition_backend, reference=reference,
                  batch_ticks=batch_ticks, device=device,
                  device_executor=device_executor,
                  device_budget=device_budget)


def _op_cls(cls, reference: bool):
    # Columnar operator class, or its pre-refactor oracle twin.
    if not reference:
        return cls
    from .reference import REFERENCE_OPS
    return REFERENCE_OPS.get(cls, cls)


@dataclasses.dataclass
class Workflow:
    engine: Engine
    monitored: List[Operator]
    edges: List[Edge]
    controllers: list
    sink: Optional[Sink]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def run(self, max_ticks: int = 200_000) -> int:
        return self.engine.run(max_ticks)


def _attach(engine: Engine, op: Operator, strategy: str,
            cfg: Optional[ReshapeConfig], **kwargs):
    if strategy == "none":
        return None
    if strategy == "reshape":
        return engine.attach_controller(op, cfg, ReshapeController)
    if strategy == "flux":
        return engine.attach_controller(op, cfg, FluxController)
    if strategy == "flowjoin":
        return engine.attach_controller(op, cfg, FlowJoinController, **kwargs)
    raise ValueError(f"unknown strategy {strategy!r}")


# --------------------------------------------------------------------- #
# W1: tweet/slang join (the running example)                             #
# --------------------------------------------------------------------- #
def build_w1(
    *,
    strategy: str = "reshape",
    num_workers: int = 48,
    service_rate: int = 4,
    scale: float = 1.0,
    cfg: Optional[ReshapeConfig] = None,
    pin_helpers: bool = True,
    seed: int = 0,
    partition_backend=None,
    reference: bool = False,
    batch_ticks: int = 1,
    snapshot_every: int = 1,
    device="cuda",
    device_executor="host",
    device_budget=None,
) -> Workflow:
    keys, vals = datasets.tweets_stream(scale, seed)
    nkeys = datasets.NUM_LOCATIONS
    emit_rate = num_workers * service_rate          # join is the bottleneck

    eng = _engine(reference, partition_backend, batch_ticks, device,
                  device_executor, device_budget)
    src = eng.add_source(Source("tweets", keys, vals, emit_rate))
    filt = eng.add_op(Filter("filter", num_workers, emit_rate,
                             predicate=lambda k, v: np.ones(k.shape, dtype=bool)))
    join = eng.add_op(_op_cls(HashJoinProbe, reference)(
        "join", num_workers, service_rate))
    sink = eng.add_op(Sink("viz", nkeys, snapshot_every=snapshot_every))

    eng.connect(src, filt, nkeys)
    join_edge = eng.connect(filt, join, nkeys)
    eng.connect(join, sink, nkeys)

    bk, bv = datasets.slang_table()
    join.install_build(join_edge.routing, bk, bv)

    if cfg is None:
        cfg = ReshapeConfig()
    if pin_helpers and strategy != "none":
        # Paper §7.2: CA's worker is helped by AZ's (4) — IL variant uses 17.
        ca_worker = datasets.CA % num_workers
        cfg.pinned_helpers.setdefault(ca_worker, datasets.AZ % num_workers)
    ctrl = _attach(eng, join, strategy, cfg)

    counts = datasets.tweet_counts(scale)
    return Workflow(
        engine=eng, monitored=[join], edges=[join_edge],
        controllers=[c for c in [ctrl] if c], sink=sink,
        meta=dict(
            counts=counts,
            ca=datasets.CA, az=datasets.AZ, il=datasets.IL, tx=datasets.TX,
            ca_worker=datasets.CA % num_workers,
            az_worker=datasets.AZ % num_workers,
            il_worker=datasets.IL % num_workers,
            tx_worker=datasets.TX % num_workers,
            actual_ca_az=counts[datasets.CA] / counts[datasets.AZ],
            actual_ca_il=counts[datasets.CA] / counts[datasets.IL],
        ),
    )


# --------------------------------------------------------------------- #
# W2: DSB-like star join + group-by (two monitored joins)                #
# --------------------------------------------------------------------- #
def build_w2(
    *,
    strategy: str = "reshape",
    num_workers: int = 40,
    service_rate: int = 4,
    n_tuples: int = 60_000,
    cfg: Optional[ReshapeConfig] = None,
    seed: int = 1,
    partition_backend=None,
    reference: bool = False,
    batch_ticks: int = 1,
    snapshot_every: int = 1,
    device="cuda",
    device_executor="host",
    device_budget=None,
) -> Workflow:
    spec = datasets.DsbSpec()
    dates, items, custs, vals = datasets.dsb_sales(n_tuples, spec, seed)
    emit_rate = num_workers * service_rate

    eng = _engine(reference, partition_backend, batch_ticks, device,
                  device_executor, device_budget)
    # vals columns: [item, customer, amount] so downstream re-keys by item.
    payload = np.stack([items.astype(np.float64), custs.astype(np.float64), vals], axis=1)
    src = eng.add_source(Source("sales", dates, payload, emit_rate))

    _join = _op_cls(HashJoinProbe, reference)
    join_date = eng.add_op(_join("join_date", num_workers, service_rate))
    rekey = eng.add_op(Project("rekey_item", num_workers, emit_rate,
                               fn=lambda k, v: (v[:, 0].astype(np.int64), v[:, 1:])))
    join_item = eng.add_op(_join("join_item", num_workers, service_rate))
    grp = eng.add_op(_op_cls(GroupByAgg, reference)(
        "groupby_item", num_workers, emit_rate))
    sink = eng.add_op(Sink("viz", spec.num_items, snapshot_every=snapshot_every))

    e_date = eng.connect(src, join_date, spec.num_dates)
    eng.connect(join_date, rekey, spec.num_dates)
    e_item = eng.connect(rekey, join_item, spec.num_items)
    e_grp = eng.connect(join_item, grp, spec.num_items)
    eng.connect(grp, sink, spec.num_items)

    # dimension tables: one row per key
    join_date.install_build(e_date.routing,
                            np.arange(spec.num_dates), np.ones(spec.num_dates))
    join_item.install_build(e_item.routing,
                            np.arange(spec.num_items), np.ones(spec.num_items))

    ctrls = []
    for op in (join_date, join_item):
        c = _attach(eng, op, strategy,
                    dataclasses.replace(cfg) if cfg is not None else None)
        if c:
            ctrls.append(c)

    return Workflow(
        engine=eng, monitored=[join_date, join_item], edges=[e_date, e_item],
        controllers=ctrls, sink=sink,
        meta=dict(spec=spec, n=n_tuples, groupby=grp, grp_edge=e_grp),
    )


# --------------------------------------------------------------------- #
# W3: range-partitioned sort (§7.10)                                     #
# --------------------------------------------------------------------- #
def build_w3(
    *,
    strategy: str = "reshape",
    num_workers: int = 20,
    service_rate: int = 6,
    n_tuples: int = 40_000,
    cfg: Optional[ReshapeConfig] = None,
    seed: int = 2,
    partition_backend=None,
    reference: bool = False,
    batch_ticks: int = 1,
    snapshot_every: int = 1,
    device="cuda",
    device_executor="host",
    device_budget=None,
) -> Workflow:
    prices = datasets.tpch_orders(n_tuples, seed)
    bounds = datasets.price_ranges(num_workers * 2)   # 2 ranges per worker
    rids = datasets.range_ids(prices, bounds)
    nranges = num_workers * 2
    emit_rate = num_workers * service_rate

    eng = _engine(reference, partition_backend, batch_ticks, device,
                  device_executor, device_budget)
    src = eng.add_source(Source("orders", rids, prices, emit_rate))
    sort = eng.add_op(_op_cls(RangeSort, reference)(
        "sort", num_workers, service_rate))
    sink = eng.add_op(Sink("out", nranges, snapshot_every=snapshot_every))

    e_sort = eng.connect(src, sort, nranges)
    eng.connect(sort, sink, nranges)

    ctrl = _attach(eng, sort, strategy, cfg)
    return Workflow(
        engine=eng, monitored=[sort], edges=[e_sort],
        controllers=[c for c in [ctrl] if c], sink=sink,
        meta=dict(prices=prices, bounds=bounds, nranges=nranges),
    )


# --------------------------------------------------------------------- #
# W4: synthetic changing distribution (§7.8)                             #
# --------------------------------------------------------------------- #
def build_w4(
    *,
    strategy: str = "reshape",
    num_workers: int = 40,
    service_rate: int = 4,
    n_tuples: int = 80_000,
    cfg: Optional[ReshapeConfig] = None,
    seed: int = 3,
    partition_backend=None,
    reference: bool = False,
    batch_ticks: int = 1,
    snapshot_every: int = 1,
    device="cuda",
    device_executor="host",
    device_budget=None,
) -> Workflow:
    num_keys = 42
    keys, vals = datasets.synthetic_changing(n_tuples, num_keys, seed)
    emit_rate = num_workers * service_rate

    eng = _engine(reference, partition_backend, batch_ticks, device,
                  device_executor, device_budget)
    src = eng.add_source(Source("synthetic", keys, vals, emit_rate))
    join = eng.add_op(_op_cls(HashJoinProbe, reference)(
        "join", num_workers, service_rate))
    sink = eng.add_op(Sink("viz", num_keys, snapshot_every=snapshot_every))

    e = eng.connect(src, join, num_keys)
    eng.connect(join, sink, num_keys)
    bk, bv = datasets.synthetic_small_table(num_keys)
    join.install_build(e.routing, bk, bv)

    if cfg is None:
        cfg = ReshapeConfig(tau=2_000.0, eta=100.0)   # paper uses tau=2000
    # Paper §7.8 fixes skewed worker 0 (key 0) and helper worker 10.
    cfg.pinned_helpers.setdefault(0, 10)
    ctrl = _attach(eng, join, strategy, cfg)
    return Workflow(
        engine=eng, monitored=[join], edges=[e],
        controllers=[c for c in [ctrl] if c], sink=sink,
        meta=dict(num_keys=num_keys, skewed_worker=0, helper_worker=10),
    )
