"""Pipelined dataflow engine (Amber/Flink stand-in) hosting Reshape.

Layout:
  tuples.py      columnar chunks + ring-buffer worker queues (zero-copy
                 pops; phi metric source)
  exchange.py    fused one-pass exchange: partition→rank→scatter per edge
                 via ScatterPlan, pluggable torch (CUDA kernel) / numpy
                 backend; DeviceExchange stages for the resident plane
  device.py      device-resident exchange plane: one dispatch per edge
                 (or fused chain) per super-tick (partition→rank→scatter
                 →pop→fold/map/probe) through the K2 kernel, boundary-only
                 host readback, the spill tier, restores and sanitizers
  spill.py       host spill tier: budgets, CRC-checked segments, prefetch
  state.py       array-backed keyed-state containers (AggStore/ScopeRows)
  operators.py   Filter/Project/HashJoin/GroupBy/RangeSort/Sink workers
  engine.py      tick-based pipelined executor (optionally batching K
                 ticks per super-chunk pass), edges with RoutingTables,
                 state-migration synchronization, controller attachment
  reference.py   pre-refactor tuple-at-a-time data plane (testing oracle)
  baselines.py   Flux and Flow-Join (paper §7.1 baselines)
  datasets.py    synthetic tweet/DSB/TPC-H/changing-distribution streams
  workflows.py   the paper's W1-W4 experiment graphs
  metrics.py     load-balancing ratio, result-ratio series (§7 metrics)
  checkpoint.py  aligned snapshots + recovery (§2.2 fault tolerance):
                 incremental checksummed cuts, disk persistence,
                 corrupted-cut fallback (CheckpointCoordinator)
  resilience.py  incident log, retry/backoff policy, and the seeded
                 chaos harness (FaultPlan/ChaosRunner) asserting
                 bit-identical recovery under injected faults

Not ported yet from ``repro.dataflow``: the in-dispatch controller of
device.py (``DeviceController``).
"""
from .device import DeviceChunk, DeviceOpRuntime
from .engine import Edge, Engine, EngineAdapter, Source
from .exchange import (
    DeviceExchange,
    Exchange,
    NumpyPartitionBackend,
    PartitionBackend,
    ScatterPlan,
    TorchPartitionBackend,
    get_backend,
    scatter_order,
)
from .state import AggStore, ScopeRows
from .operators import (
    Filter,
    GroupByAgg,
    HashJoinBuild,
    HashJoinProbe,
    Operator,
    Project,
    RangeSort,
    Sink,
    Worker,
)
from .baselines import FlowJoinController, FluxController
from .checkpoint import CheckpointCoordinator, Cut, CutBuilder
from .resilience import (
    ChaosRunner,
    FaultEvent,
    FaultPlan,
    Incident,
    IncidentLog,
    RetryPolicy,
)
from .workflows import Workflow, build_w1, build_w2, build_w3, build_w4

__all__ = [
    "AggStore",
    "ChaosRunner",
    "CheckpointCoordinator",
    "Cut",
    "CutBuilder",
    "DeviceChunk",
    "DeviceExchange",
    "DeviceOpRuntime",
    "Edge",
    "Engine",
    "EngineAdapter",
    "Exchange",
    "FaultEvent",
    "FaultPlan",
    "Incident",
    "IncidentLog",
    "NumpyPartitionBackend",
    "PartitionBackend",
    "RetryPolicy",
    "ScatterPlan",
    "ScopeRows",
    "TorchPartitionBackend",
    "Source",
    "get_backend",
    "scatter_order",
    "Filter",
    "GroupByAgg",
    "HashJoinBuild",
    "HashJoinProbe",
    "Operator",
    "Project",
    "RangeSort",
    "Sink",
    "Worker",
    "FlowJoinController",
    "FluxController",
    "Workflow",
    "build_w1",
    "build_w2",
    "build_w3",
    "build_w4",
]
