// The one error-string entry point every kernel library exports, under one
// name, so the host binds it the same way in each library
// (utils/cuda_build.py::ERROR_STRING): the text of a CUDA error code that
// an entry point returned.

#pragma once

#include <cuda_runtime.h>

extern "C" const char* csr5_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
