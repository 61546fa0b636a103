// Error text for the codes the kernel entry points return (each returns
// cudaGetLastError() after its launch).

#include <cuda_runtime.h>

extern "C" const char *fk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
