"""GRPCInferenceService method table.

Counterpart of client_tpu/_grpc_service.py.  grpcio-tools is not a
dependency, so no ``*_pb2_grpc.py`` stubs exist; the server
(serve/grpc_server.py) registers generic method handlers from this table,
which mirrors the service definition in proto/inference.proto.
"""

from client_tpu_torch._proto import inference_pb2 as pb

SERVICE = "inference.GRPCInferenceService"

# name -> (request class, response class, client-streaming?, server-streaming?)
METHODS = {
    "ServerLive": (pb.ServerLiveRequest, pb.ServerLiveResponse, False, False),
    "ServerReady": (pb.ServerReadyRequest, pb.ServerReadyResponse, False, False),
    "ModelReady": (pb.ModelReadyRequest, pb.ModelReadyResponse, False, False),
    "ServerMetadata": (
        pb.ServerMetadataRequest,
        pb.ServerMetadataResponse,
        False,
        False,
    ),
    "ModelMetadata": (
        pb.ModelMetadataRequest,
        pb.ModelMetadataResponse,
        False,
        False,
    ),
    "ModelInfer": (pb.ModelInferRequest, pb.ModelInferResponse, False, False),
    "ModelStreamInfer": (
        pb.ModelInferRequest,
        pb.ModelStreamInferResponse,
        True,
        True,
    ),
    "ModelConfig": (pb.ModelConfigRequest, pb.ModelConfigResponse, False, False),
    "ModelStatistics": (
        pb.ModelStatisticsRequest,
        pb.ModelStatisticsResponse,
        False,
        False,
    ),
    "RepositoryIndex": (
        pb.RepositoryIndexRequest,
        pb.RepositoryIndexResponse,
        False,
        False,
    ),
    "RepositoryModelLoad": (
        pb.RepositoryModelLoadRequest,
        pb.RepositoryModelLoadResponse,
        False,
        False,
    ),
    "RepositoryModelUnload": (
        pb.RepositoryModelUnloadRequest,
        pb.RepositoryModelUnloadResponse,
        False,
        False,
    ),
    "SystemSharedMemoryStatus": (
        pb.SystemSharedMemoryStatusRequest,
        pb.SystemSharedMemoryStatusResponse,
        False,
        False,
    ),
    "SystemSharedMemoryRegister": (
        pb.SystemSharedMemoryRegisterRequest,
        pb.SystemSharedMemoryRegisterResponse,
        False,
        False,
    ),
    "SystemSharedMemoryUnregister": (
        pb.SystemSharedMemoryUnregisterRequest,
        pb.SystemSharedMemoryUnregisterResponse,
        False,
        False,
    ),
    "CudaSharedMemoryStatus": (
        pb.CudaSharedMemoryStatusRequest,
        pb.CudaSharedMemoryStatusResponse,
        False,
        False,
    ),
    "CudaSharedMemoryRegister": (
        pb.CudaSharedMemoryRegisterRequest,
        pb.CudaSharedMemoryRegisterResponse,
        False,
        False,
    ),
    "CudaSharedMemoryUnregister": (
        pb.CudaSharedMemoryUnregisterRequest,
        pb.CudaSharedMemoryUnregisterResponse,
        False,
        False,
    ),
    "TraceSetting": (pb.TraceSettingRequest, pb.TraceSettingResponse, False, False),
    "LogSettings": (pb.LogSettingsRequest, pb.LogSettingsResponse, False, False),
    "TpuSharedMemoryStatus": (
        pb.TpuSharedMemoryStatusRequest,
        pb.TpuSharedMemoryStatusResponse,
        False,
        False,
    ),
    "TpuSharedMemoryRegister": (
        pb.TpuSharedMemoryRegisterRequest,
        pb.TpuSharedMemoryRegisterResponse,
        False,
        False,
    ),
    "TpuSharedMemoryUnregister": (
        pb.TpuSharedMemoryUnregisterRequest,
        pb.TpuSharedMemoryUnregisterResponse,
        False,
        False,
    ),
}
