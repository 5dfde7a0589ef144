"""Pipelined dataflow engine (Amber/Flink stand-in) hosting Reshape.

Layout:
  tuples.py      columnar chunks + ring-buffer worker queues (zero-copy
                 pops; phi metric source)
  exchange.py    fused one-pass exchange: partition→rank→scatter per edge
                 via ScatterPlan, pluggable torch (CUDA kernel) / numpy
                 backend; DeviceExchange stages for the resident plane
  device.py      device-resident exchange plane: one dispatch per edge
                 per super-tick (partition→rank→scatter→pop→fold/map)
                 through the K2 kernel, boundary-only host readback
  state.py       array-backed keyed-state containers (AggStore/ScopeRows)
  operators.py   Filter/Project/HashJoin/GroupBy/RangeSort/Sink workers
  engine.py      tick-based pipelined executor (optionally batching K
                 ticks per super-chunk pass), edges with RoutingTables,
                 state-migration synchronization, controller attachment
  baselines.py   Flux and Flow-Join (paper §7.1 baselines)
  datasets.py    synthetic tweet/DSB/TPC-H/changing-distribution streams
  workflows.py   the paper's W1-W4 experiment graphs
  resilience.py  incident log and retry/backoff policy

Not ported yet from ``repro.dataflow``: the probe, chain-fusion, spill,
restore and in-dispatch controller parts of device.py, reference.py,
metrics.py, checkpoint.py, spill.py and the chaos harness of resilience.py.
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
from .resilience import Incident, IncidentLog, RetryPolicy
from .workflows import Workflow, build_w1, build_w2, build_w3, build_w4

__all__ = [
    "AggStore",
    "DeviceChunk",
    "DeviceExchange",
    "DeviceOpRuntime",
    "Edge",
    "Engine",
    "EngineAdapter",
    "Exchange",
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
