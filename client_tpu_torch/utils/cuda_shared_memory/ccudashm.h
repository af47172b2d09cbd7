/* C ABI of libccudashm: CUDA device regions shared over CUDA IPC, for
 * clients that are not Python (the role of Triton's libccudashm.so; the
 * JAX package's counterpart is src/cpp/shm/ctpushm.h).  A region is one
 * cudaMalloc allocation, exported as the 64 bytes of its
 * cudaIpcMemHandle_t, which a client registers with a server
 * (RegisterCudaSharedMemory); a server in another process opens the same
 * bytes with cudaIpcOpenMemHandle.  The Python module beside this header
 * (cuda_shared_memory, over its torch extension) makes and opens the same
 * regions: a handle of either opens in the other.
 *
 * Reads and writes are synchronous host <-> device copies: a write
 * returns once its bytes are in device memory, so another process reads
 * them.  There is no host window and no fallback: without a device,
 * create and open return NULL and CudaShmLastError holds cudart's
 * message.
 *
 * The handle is opaque bytes here, so this header needs no CUDA header:
 * only ccudashm.cc includes cuda_runtime.h. */
#pragma once

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define CUDA_SHM_HANDLE_BYTES 64 /* sizeof(cudaIpcMemHandle_t) */

enum CudaShmStatus {
  CUDA_SHM_OK = 0,
  CUDA_SHM_ERR_CUDA = -1,     /* a cudart call failed */
  CUDA_SHM_ERR_RANGE = -2,    /* bytes outside the region */
  CUDA_SHM_ERR_HANDLE = -3,   /* a NULL region */
  CUDA_SHM_ERR_CAPACITY = -4, /* a buffer too small for the raw handle */
};

/* This thread's message for its most recent failure. */
const char* CudaShmLastError(void);

/* cudaMalloc byte_size zeroed bytes on device_id; NULL on failure. */
void* CudaShmRegionCreate(uint64_t byte_size, int device_id);
/* Open another process's region from its CUDA_SHM_HANDLE_BYTES raw handle
 * bytes, byte_size of them, on device_id; NULL on failure. */
void* CudaShmRegionOpen(
    const void* raw_handle, uint64_t byte_size, int device_id);
/* size bytes at offset: host to device, device to host.  CudaShmStatus. */
int CudaShmWrite(
    void* region, uint64_t offset, const void* src, uint64_t size);
int CudaShmRead(void* region, uint64_t offset, void* dst, uint64_t size);
/* The region's device pointer, bytes and device (NULL, 0, -1 for NULL). */
void* CudaShmDevicePtr(void* region);
uint64_t CudaShmByteSize(void* region);
int CudaShmDeviceId(void* region);
/* Copy the raw handle into out; CUDA_SHM_HANDLE_BYTES on success, a
 * CudaShmStatus (< 0) on error. */
int CudaShmGetRawHandle(void* region, void* out, uint64_t capacity);
/* cudaFree a region made here, cudaIpcCloseMemHandle one opened here. */
int CudaShmRegionDestroy(void* region);

#ifdef __cplusplus
} /* extern "C" */
#endif
