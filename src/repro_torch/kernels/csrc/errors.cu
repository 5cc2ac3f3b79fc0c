// The one error-string export shared by every kernel's launcher: each
// `*_launch` function returns a cudaError_t, and the Python binding
// (kernels/_build.py::check) turns a non-zero code into its message.

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
