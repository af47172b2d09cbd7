// CUDA shared-memory regions over cudart: the native half of
// client_tpu_torch.utils.cuda_shared_memory (the reference client's
// libccudashm.so role; the JAX package's counterpart is
// src/cpp/shm/ctpushm.cc, which keeps a host window because PJRT has no
// IPC export).
//
// A Mapping is one device allocation: made here (cudaMalloc, exported with
// cudaIpcGetMemHandle) or opened from another process's 64-byte
// cudaIpcMemHandle_t (cudaIpcOpenMemHandle).  as_tensor gives a flat uint8
// CUDA tensor over it whose deleter holds a shared_ptr to the Mapping, so
// cudaFree / cudaIpcCloseMemHandle runs only once the Python owner and
// every view are gone: a view handed to a request outlives an unregister.
//
// One handle opens once per process: a second cudaIpcOpenMemHandle of a
// handle already open here can fail, so open() hands out the live Mapping
// of that handle while any holder keeps it.
//
// Every failing cudart call raises with cudaGetErrorString, streamed as a
// C string (a streamed integer crashed a check on the card), and clears
// cudart's last error so no later launch check reports it again.

#include <torch/extension.h>

#include <c10/cuda/CUDAGuard.h>
#include <cuda_runtime.h>

#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>

namespace {

constexpr size_t kHandleBytes = sizeof(cudaIpcMemHandle_t);  // 64

void check(cudaError_t err, const char* what) {
  if (err != cudaSuccess) {
    cudaGetLastError();
    TORCH_CHECK(false, what, " failed: ", cudaGetErrorString(err));
  }
}

struct Mapping {
  void* ptr = nullptr;
  int64_t byte_size = 0;
  int device = 0;
  bool imported = false;  // opened from a handle (else allocated here)
  std::string handle;

  ~Mapping() {
    if (ptr == nullptr) return;
    // the last view can die while copies that read it are queued on some
    // stream: wait for the device before the memory goes.  Errors here
    // (a process tearing down its context) cannot be raised.
    cudaSetDevice(device);
    cudaDeviceSynchronize();
    if (imported) {
      cudaIpcCloseMemHandle(ptr);
    } else {
      cudaFree(ptr);
    }
    cudaGetLastError();
  }
};

std::mutex g_open_mu;
std::map<std::string, std::weak_ptr<Mapping>> g_open;  // handle -> mapping

std::shared_ptr<Mapping> create(int64_t byte_size, int64_t device_id) {
  TORCH_CHECK(byte_size > 0, "a CUDA shared-memory region needs bytes");
  c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device_id));
  void* ptr = nullptr;
  check(cudaMalloc(&ptr, static_cast<size_t>(byte_size)), "cudaMalloc");
  auto m = std::make_shared<Mapping>();  // frees ptr if the export fails
  m->ptr = ptr;
  m->device = static_cast<int>(device_id);
  m->byte_size = byte_size;
  cudaIpcMemHandle_t h;
  check(cudaIpcGetMemHandle(&h, m->ptr), "cudaIpcGetMemHandle");
  m->handle.assign(reinterpret_cast<const char*>(&h), kHandleBytes);
  return m;
}

std::shared_ptr<Mapping> open(py::bytes handle_bytes, int64_t byte_size,
                              int64_t device_id) {
  std::string handle = handle_bytes;
  TORCH_CHECK(handle.size() == kHandleBytes,
              "a cudaIpcMemHandle_t is 64 bytes");
  TORCH_CHECK(byte_size > 0, "a CUDA shared-memory region needs bytes");
  std::lock_guard<std::mutex> lock(g_open_mu);
  auto it = g_open.find(handle);
  if (it != g_open.end()) {
    if (auto live = it->second.lock()) {
      TORCH_CHECK(live->device == device_id,
                  "handle already open on another device");
      TORCH_CHECK(byte_size <= live->byte_size,
                  "handle already open with fewer bytes");
      return live;
    }
  }
  c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device_id));
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle.data(), kHandleBytes);
  void* ptr = nullptr;
  check(cudaIpcOpenMemHandle(&ptr, h, cudaIpcMemLazyEnablePeerAccess),
        "cudaIpcOpenMemHandle");
  auto m = std::make_shared<Mapping>();
  m->ptr = ptr;
  m->device = static_cast<int>(device_id);
  m->byte_size = byte_size;
  m->imported = true;
  m->handle = handle;
  g_open[handle] = m;
  return m;
}

torch::Tensor as_tensor(const std::shared_ptr<Mapping>& m) {
  auto options = torch::TensorOptions()
                     .dtype(torch::kUInt8)
                     .device(torch::kCUDA, m->device);
  std::shared_ptr<Mapping> keep = m;
  return torch::from_blob(
      m->ptr, {m->byte_size}, [keep](void*) mutable { keep.reset(); },
      options);
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  py::class_<Mapping, std::shared_ptr<Mapping>>(mod, "Mapping")
      .def_readonly("byte_size", &Mapping::byte_size)
      .def_readonly("device", &Mapping::device)
      .def_readonly("imported", &Mapping::imported)
      .def("handle",
           [](const Mapping& m) { return py::bytes(m.handle); })
      .def("as_tensor", &as_tensor);
  mod.def("create", &create, "cudaMalloc a region and export its handle",
          py::arg("byte_size"), py::arg("device_id"));
  mod.def("open", &open, "open another process's region by its handle",
          py::arg("handle"), py::arg("byte_size"), py::arg("device_id"));
}
