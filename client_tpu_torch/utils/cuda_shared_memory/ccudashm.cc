// libccudashm over cudart (see ccudashm.h): host C++, no torch and no
// kernel.  Every failing cudart call leaves cudaGetErrorString's text in
// the calling thread's last error and clears cudart's own, so no later
// call reports it again.  Each call makes the region's device current for
// its cudart calls and restores the caller's device after.

#include "ccudashm.h"

#include <cuda_runtime.h>

#include <cstring>
#include <string>

namespace {

static_assert(sizeof(cudaIpcMemHandle_t) == CUDA_SHM_HANDLE_BYTES,
              "a cudaIpcMemHandle_t is 64 bytes");

thread_local std::string g_last_error;

struct Region {
  void* ptr = nullptr;
  uint64_t byte_size = 0;
  int device = 0;
  bool imported = false;  // opened from a handle (else allocated here)
  cudaIpcMemHandle_t handle;
};

int
Fail(int status, const std::string& message)
{
  g_last_error = message;
  return status;
}

bool
Ok(cudaError_t err, const char* what)
{
  if (err == cudaSuccess) return true;
  g_last_error = std::string(what) + " failed: " + cudaGetErrorString(err);
  cudaGetLastError();
  return false;
}

// Makes *device* current for its scope.
class DeviceScope {
 public:
  explicit DeviceScope(int device)
  {
    ok_ = Ok(cudaGetDevice(&previous_), "cudaGetDevice") &&
          Ok(cudaSetDevice(device), "cudaSetDevice");
  }
  ~DeviceScope()
  {
    if (ok_) cudaSetDevice(previous_);
  }
  bool ok() const { return ok_; }

 private:
  int previous_ = 0;
  bool ok_ = false;
};

int
CheckRange(const Region* r, uint64_t offset, uint64_t size)
{
  if (r == nullptr) return Fail(CUDA_SHM_ERR_HANDLE, "a NULL region");
  if (offset > r->byte_size || size > r->byte_size - offset)
    return Fail(
        CUDA_SHM_ERR_RANGE,
        std::to_string(size) + " bytes at offset " + std::to_string(offset) +
            " overrun a region of " + std::to_string(r->byte_size) +
            " bytes");
  return CUDA_SHM_OK;
}

}  // namespace

extern "C" {

const char*
CudaShmLastError(void)
{
  return g_last_error.c_str();
}

void*
CudaShmRegionCreate(uint64_t byte_size, int device_id)
{
  if (byte_size == 0) {
    Fail(CUDA_SHM_ERR_RANGE, "a CUDA shared-memory region needs bytes");
    return nullptr;
  }
  DeviceScope scope(device_id);
  if (!scope.ok()) return nullptr;
  auto* r = new Region();
  r->byte_size = byte_size;
  r->device = device_id;
  if (!Ok(cudaMalloc(&r->ptr, byte_size), "cudaMalloc")) {
    delete r;
    return nullptr;
  }
  if (!Ok(cudaMemset(r->ptr, 0, byte_size), "cudaMemset") ||
      !Ok(cudaDeviceSynchronize(), "cudaDeviceSynchronize") ||
      !Ok(cudaIpcGetMemHandle(&r->handle, r->ptr), "cudaIpcGetMemHandle")) {
    cudaFree(r->ptr);
    cudaGetLastError();
    delete r;
    return nullptr;
  }
  return r;
}

void*
CudaShmRegionOpen(const void* raw_handle, uint64_t byte_size, int device_id)
{
  if (raw_handle == nullptr || byte_size == 0) {
    Fail(CUDA_SHM_ERR_HANDLE, "opening a region needs its raw handle and "
                              "its bytes");
    return nullptr;
  }
  DeviceScope scope(device_id);
  if (!scope.ok()) return nullptr;
  auto* r = new Region();
  r->byte_size = byte_size;
  r->device = device_id;
  r->imported = true;
  std::memcpy(&r->handle, raw_handle, CUDA_SHM_HANDLE_BYTES);
  if (!Ok(cudaIpcOpenMemHandle(
              &r->ptr, r->handle, cudaIpcMemLazyEnablePeerAccess),
          "cudaIpcOpenMemHandle")) {
    delete r;
    return nullptr;
  }
  return r;
}

int
CudaShmWrite(void* region, uint64_t offset, const void* src, uint64_t size)
{
  auto* r = static_cast<Region*>(region);
  const int status = CheckRange(r, offset, size);
  if (status != CUDA_SHM_OK || size == 0) return status;
  DeviceScope scope(r->device);
  // a copy from pageable memory may return before its DMA ends: wait for
  // it, so another process reads these bytes
  if (!scope.ok() ||
      !Ok(cudaMemcpy(static_cast<char*>(r->ptr) + offset, src, size,
                     cudaMemcpyHostToDevice),
          "cudaMemcpy (host to device)") ||
      !Ok(cudaStreamSynchronize(nullptr), "cudaStreamSynchronize"))
    return CUDA_SHM_ERR_CUDA;
  return CUDA_SHM_OK;
}

int
CudaShmRead(void* region, uint64_t offset, void* dst, uint64_t size)
{
  auto* r = static_cast<Region*>(region);
  const int status = CheckRange(r, offset, size);
  if (status != CUDA_SHM_OK || size == 0) return status;
  DeviceScope scope(r->device);
  if (!scope.ok() ||
      !Ok(cudaMemcpy(dst, static_cast<const char*>(r->ptr) + offset, size,
                     cudaMemcpyDeviceToHost),
          "cudaMemcpy (device to host)"))
    return CUDA_SHM_ERR_CUDA;
  return CUDA_SHM_OK;
}

void*
CudaShmDevicePtr(void* region)
{
  return region == nullptr ? nullptr : static_cast<Region*>(region)->ptr;
}

uint64_t
CudaShmByteSize(void* region)
{
  return region == nullptr ? 0 : static_cast<Region*>(region)->byte_size;
}

int
CudaShmDeviceId(void* region)
{
  return region == nullptr ? -1 : static_cast<Region*>(region)->device;
}

int
CudaShmGetRawHandle(void* region, void* out, uint64_t capacity)
{
  if (region == nullptr) return Fail(CUDA_SHM_ERR_HANDLE, "a NULL region");
  if (out == nullptr || capacity < CUDA_SHM_HANDLE_BYTES)
    return Fail(CUDA_SHM_ERR_CAPACITY,
                "a raw handle needs 64 bytes, the buffer has " +
                    std::to_string(out == nullptr ? 0 : capacity));
  std::memcpy(
      out, &static_cast<Region*>(region)->handle, CUDA_SHM_HANDLE_BYTES);
  return CUDA_SHM_HANDLE_BYTES;
}

int
CudaShmRegionDestroy(void* region)
{
  auto* r = static_cast<Region*>(region);
  if (r == nullptr) return Fail(CUDA_SHM_ERR_HANDLE, "a NULL region");
  int status = CUDA_SHM_OK;
  {
    DeviceScope scope(r->device);
    if (!scope.ok())
      status = CUDA_SHM_ERR_CUDA;
    else if (r->imported)
      status = Ok(cudaIpcCloseMemHandle(r->ptr), "cudaIpcCloseMemHandle")
                   ? CUDA_SHM_OK
                   : CUDA_SHM_ERR_CUDA;
    else
      status = Ok(cudaFree(r->ptr), "cudaFree") ? CUDA_SHM_OK
                                                 : CUDA_SHM_ERR_CUDA;
  }
  delete r;
  return status;
}

}  // extern "C"
