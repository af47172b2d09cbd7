// Opens a CUDA region of another process through libccudashm (ccudashm.h)
// and reads or writes its bytes: the check that a region made by one
// implementation (the Python module's torch extension, say) opens in the
// other.  Every bytes argument and answer is "x" followed by its hex.
//
//   ccudashm_tool read xHANDLE BYTE_SIZE DEVICE_ID
//       -> "ok xBYTES" (all BYTE_SIZE bytes of the region)
//   ccudashm_tool write xHANDLE BYTE_SIZE DEVICE_ID OFFSET xBYTES
//       -> "ok"
//
// A failure prints "error MESSAGE" (CudaShmLastError) and exits 1.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "ccudashm.h"

namespace {

std::string
Unhex(const char* token)
{
  std::string out;
  const size_t n = std::strlen(token);
  for (size_t i = 1; i + 1 < n; i += 2) {
    const char pair[3] = {token[i], token[i + 1], 0};
    out.push_back(static_cast<char>(std::strtol(pair, nullptr, 16)));
  }
  return out;
}

int
Failed()
{
  std::printf("error %s\n", CudaShmLastError());
  return 1;
}

}  // namespace

int
main(int argc, char** argv)
{
  const bool read = argc == 5 && !std::strcmp(argv[1], "read");
  const bool write = argc == 7 && !std::strcmp(argv[1], "write");
  if (!read && !write) {
    std::fprintf(stderr,
                 "usage: %s read xHANDLE BYTE_SIZE DEVICE_ID\n"
                 "       %s write xHANDLE BYTE_SIZE DEVICE_ID OFFSET xBYTES\n",
                 argv[0], argv[0]);
    return 2;
  }
  const std::string handle = Unhex(argv[2]);
  if (handle.size() != CUDA_SHM_HANDLE_BYTES) {
    std::printf("error a raw handle is %d bytes, got %zu\n",
                CUDA_SHM_HANDLE_BYTES, handle.size());
    return 1;
  }
  const uint64_t byte_size = std::strtoull(argv[3], nullptr, 10);
  void* region =
      CudaShmRegionOpen(handle.data(), byte_size, std::atoi(argv[4]));
  if (region == nullptr) return Failed();
  int status;
  std::string answer = "ok";
  if (read) {
    std::vector<unsigned char> bytes(byte_size);
    status = CudaShmRead(region, 0, bytes.data(), byte_size);
    answer += " x";
    char digits[3];
    for (const unsigned char b : bytes) {
      std::snprintf(digits, sizeof(digits), "%02x", b);
      answer += digits;
    }
  } else {
    const std::string bytes = Unhex(argv[6]);
    status = CudaShmWrite(
        region, std::strtoull(argv[5], nullptr, 10), bytes.data(),
        bytes.size());
  }
  if (status != CUDA_SHM_OK) {
    const int rc = Failed();
    CudaShmRegionDestroy(region);
    return rc;
  }
  if (CudaShmRegionDestroy(region) != CUDA_SHM_OK) return Failed();
  std::printf("%s\n", answer.c_str());
  return 0;
}
