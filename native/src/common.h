// Shared declarations for the cdmi native runtime library.
//
// The framework's host-side C++ components — the counterparts of the
// reference's native layer (ReconstructionLib + CUDA host code). Exposed with
// a plain C ABI and consumed from Python via ctypes (no pybind11).
#pragma once

#include <cstdint>

#if defined(_WIN32)
#define CDMI_API extern "C" __declspec(dllexport)
#else
#define CDMI_API extern "C" __attribute__((visibility("default")))
#endif
