"""perf — the port's perf_analyzer-class load & measurement harness.

Counterpart of client_tpu/perf (the reference perf_analyzer, reference
src/c++/perf_analyzer/): pluggable client backends (gRPC and HTTP over
the port's own clients, the in-process InferenceEngine, TorchServe and
TF-Serving with their hermetic fakes, a mock), data loading (generated /
directory / JSON), shared-memory input staging (system or CUDA device
memory), concurrency and request-rate load managers with
Poisson/constant/custom schedules, the asyncio concurrency manager over
the port's grpc.aio client (``--async``), stateful sequence workloads, a
windowed stability-seeking profiler, the rendezvous that coordinates
ranks (``--world-size``), server /metrics scraping with local GPU gauges
and a device probe, and stdout/CSV/JSON reporting.  CLI: ``python -m
client_tpu_torch.perf``; its in-process models, CUDA regions and probe
run on ``cuda`` unless the caller passes ``--device cpu``.
"""

from client_tpu_torch.perf.client_backend import (
    BackendKind,
    ClientBackend,
    ClientBackendFactory,
    MockClientBackend,
    MockStats,
)
from client_tpu_torch.perf.data_loader import DataLoader
from client_tpu_torch.perf.infer_data import (
    SharedMemoryType,
    create_infer_data_manager,
)
from client_tpu_torch.perf.load_manager import (
    AsyncConcurrencyManager,
    ConcurrencyManager,
    CustomLoadManager,
    LoadManager,
    RequestRateManager,
)
from client_tpu_torch.perf.model_parser import ModelParser, SchedulerType
from client_tpu_torch.perf.profiler import InferenceProfiler, PerfStatus
from client_tpu_torch.perf.rendezvous import Rendezvous
from client_tpu_torch.perf.report import print_summary, write_csv, write_json
from client_tpu_torch.perf.sequence_manager import SequenceManager

__all__ = [
    "AsyncConcurrencyManager",
    "BackendKind",
    "ClientBackend",
    "ClientBackendFactory",
    "ConcurrencyManager",
    "CustomLoadManager",
    "DataLoader",
    "InferenceProfiler",
    "LoadManager",
    "MockClientBackend",
    "MockStats",
    "PerfStatus",
    "Rendezvous",
    "RequestRateManager",
    "SequenceManager",
    "SharedMemoryType",
    "create_infer_data_manager",
    "print_summary",
    "write_csv",
    "write_json",
]
