// Error reporting for the ctypes-bound kernel entry points.
#include <cuda_runtime.h>

extern "C" const char* tts_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
