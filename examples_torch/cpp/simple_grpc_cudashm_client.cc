// Native CUDA shared-memory example: tensors staged in CUDA device memory
// by a C++ client.  Two regions are made through the libccudashm C ABI
// (client_tpu_torch/utils/cuda_shared_memory/ccudashm.h), their 64-byte
// cudaIpcMemHandle_t handed to the server over gRPC, and infer runs with
// every input and output referenced by region; the server opens the
// regions over CUDA IPC and reads and writes them on the device, and the
// results are read back through the ABI: tensor bytes never ride the
// request.  Counterpart of src/cpp/examples/simple_grpc_tpushm_client.cc
// (and of examples_torch/simple_grpc_cudashm_client.py).
//
// Usage: simple_grpc_cudashm_client [-u host:port]
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <iostream>
#include <string>
#include <vector>

#include "ccudashm.h"
#include "grpc_client.h"

// A region is freed on every exit path: device memory is the process's
// until then.
struct RegionGuard {
  void* region;
  ~RegionGuard()
  {
    if (region != nullptr) CudaShmRegionDestroy(region);
  }
};

namespace tc = ctpu;

#define FAIL_IF_ERR(X, MSG)                                 \
  do {                                                      \
    tc::Error err__ = (X);                                  \
    if (!err__.IsOk()) {                                    \
      fprintf(stderr, "error: %s: %s\n", (MSG),            \
              err__.Message().c_str());                     \
      return 1;                                             \
    }                                                       \
  } while (false)

#define FAIL_IF_SHM(X, MSG)                                 \
  do {                                                      \
    if ((X) != CUDA_SHM_OK) {                               \
      fprintf(stderr, "error: %s: %s\n", (MSG),            \
              CudaShmLastError());                          \
      return 1;                                             \
    }                                                       \
  } while (false)

int
main(int argc, char** argv)
{
  std::string url = "localhost:8001";
  for (int i = 1; i < argc - 1; ++i) {
    if (!std::strcmp(argv[i], "-u")) url = argv[++i];
  }

  std::unique_ptr<tc::InferenceServerGrpcClient> client;
  FAIL_IF_ERR(
      tc::InferenceServerGrpcClient::Create(&client, url), "create client");

  constexpr uint64_t kTensorBytes = 16 * sizeof(int32_t);
  void* in_region = CudaShmRegionCreate(2 * kTensorBytes, 0);
  RegionGuard in_guard{in_region};
  if (in_region == nullptr) {
    fprintf(stderr, "error: region create: %s\n", CudaShmLastError());
    return 1;
  }
  void* out_region = CudaShmRegionCreate(2 * kTensorBytes, 0);
  RegionGuard out_guard{out_region};
  if (out_region == nullptr) {
    fprintf(stderr, "error: region create: %s\n", CudaShmLastError());
    return 1;
  }

  int32_t input0[16], input1[16];
  for (int i = 0; i < 16; ++i) {
    input0[i] = i;
    input1[i] = 5;
  }
  FAIL_IF_SHM(
      CudaShmWrite(in_region, 0, input0, kTensorBytes), "write INPUT0");
  FAIL_IF_SHM(
      CudaShmWrite(in_region, kTensorBytes, input1, kTensorBytes),
      "write INPUT1");

  char in_handle[CUDA_SHM_HANDLE_BYTES], out_handle[CUDA_SHM_HANDLE_BYTES];
  if (CudaShmGetRawHandle(in_region, in_handle, sizeof(in_handle)) !=
          CUDA_SHM_HANDLE_BYTES ||
      CudaShmGetRawHandle(out_region, out_handle, sizeof(out_handle)) !=
          CUDA_SHM_HANDLE_BYTES) {
    fprintf(stderr, "error: raw handle: %s\n", CudaShmLastError());
    return 1;
  }

  client->UnregisterCudaSharedMemory("cuda_in_cc");
  client->UnregisterCudaSharedMemory("cuda_out_cc");
  FAIL_IF_ERR(
      client->RegisterCudaSharedMemory(
          "cuda_in_cc", std::string(in_handle, sizeof(in_handle)), 0,
          2 * kTensorBytes),
      "register input region");
  FAIL_IF_ERR(
      client->RegisterCudaSharedMemory(
          "cuda_out_cc", std::string(out_handle, sizeof(out_handle)), 0,
          2 * kTensorBytes),
      "register output region");

  tc::InferInput in0("INPUT0", {1, 16}, "INT32");
  tc::InferInput in1("INPUT1", {1, 16}, "INT32");
  in0.SetSharedMemory("cuda_in_cc", kTensorBytes, 0);
  in1.SetSharedMemory("cuda_in_cc", kTensorBytes, kTensorBytes);
  tc::InferRequestedOutput out0("OUTPUT0"), out1("OUTPUT1");
  out0.SetSharedMemory("cuda_out_cc", kTensorBytes, 0);
  out1.SetSharedMemory("cuda_out_cc", kTensorBytes, kTensorBytes);

  tc::InferOptions options("simple");
  tc::InferResult* result = nullptr;
  FAIL_IF_ERR(
      client->Infer(&result, options, {&in0, &in1}, {&out0, &out1}),
      "inference failed");
  std::unique_ptr<tc::InferResult> owner(result);

  int32_t sum[16], diff[16];
  FAIL_IF_SHM(CudaShmRead(out_region, 0, sum, kTensorBytes), "read OUTPUT0");
  FAIL_IF_SHM(
      CudaShmRead(out_region, kTensorBytes, diff, kTensorBytes),
      "read OUTPUT1");
  for (int i = 0; i < 16; ++i) {
    std::cout << input0[i] << " + " << input1[i] << " = " << sum[i]
              << std::endl;
    if (sum[i] != input0[i] + input1[i] ||
        diff[i] != input0[i] - input1[i]) {
      std::cerr << "error: incorrect result in CUDA region" << std::endl;
      return 1;
    }
  }

  FAIL_IF_ERR(
      client->UnregisterCudaSharedMemory("cuda_in_cc"), "unregister input");
  FAIL_IF_ERR(
      client->UnregisterCudaSharedMemory("cuda_out_cc"), "unregister output");

  std::cout << "PASS: simple_grpc_cudashm_client (native)" << std::endl;
  return 0;
}
