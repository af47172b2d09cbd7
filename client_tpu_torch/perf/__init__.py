"""perf — the port's perf_analyzer-class load & measurement harness.

Counterpart of client_tpu/perf (the reference perf_analyzer, reference
src/c++/perf_analyzer/): pluggable client backends (gRPC over the port's
own client, the in-process InferenceEngine, a mock), data loading
(generated / directory / JSON), shared-memory input staging (system or
CUDA device memory), concurrency and request-rate load managers with
Poisson/constant/custom schedules, stateful sequence workloads, a
windowed stability-seeking profiler, server /metrics scraping with local
GPU gauges and a device probe, and stdout/CSV/JSON reporting.  CLI:
``python -m client_tpu_torch.perf``; it runs on ``cuda`` unless the
caller passes ``--device cpu``.  The rendezvous module keeps only the
frame transport the fleet tier speaks.
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
    ConcurrencyManager,
    CustomLoadManager,
    LoadManager,
    RequestRateManager,
)
from client_tpu_torch.perf.model_parser import ModelParser, SchedulerType
from client_tpu_torch.perf.profiler import InferenceProfiler, PerfStatus
from client_tpu_torch.perf.report import print_summary, write_csv, write_json
from client_tpu_torch.perf.sequence_manager import SequenceManager

__all__ = [
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
    "RequestRateManager",
    "SequenceManager",
    "SharedMemoryType",
    "create_infer_data_manager",
    "print_summary",
    "write_csv",
    "write_json",
]
