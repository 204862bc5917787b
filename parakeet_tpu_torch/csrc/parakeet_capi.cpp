// parakeet_capi.cpp — flat C API over the parakeet_tpu_torch package (the
// PyTorch/CUDA port; a copy of the repository's csrc/parakeet_capi.cpp
// that drives the port's bridge module, with the same ABI, parakeet.h).
//
// Design: the C side is a string pipe. Every call grabs the GIL, invokes
// parakeet_tpu_torch.capi (the Python bridge owning handles/options/JSON),
// and marshals str <-> char*. New features never change this ABI — they
// ride the options JSON.
//
// Interpreter ownership: if the host process already runs CPython (e.g.
// this library was dlopen'd via ctypes), we attach to it. Otherwise the
// first call initializes an interpreter and immediately releases the GIL
// (PyEval_SaveThread) so subsequent calls from ANY host thread can take
// it with PyGILState_Ensure.
//
// Built by parakeet_tpu_torch/ops/_build.py build_capi() with g++ against
// the running interpreter's headers and libpython.

#include "parakeet.h"

#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string &msg) { g_last_error = msg; }

// Format the pending Python exception into the thread-local error slot.
void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "python error";
  if (value != nullptr) {
    if (PyObject *s = PyObject_Str(value)) {
      if (const char *utf8 = PyUnicode_AsUTF8(s)) {
        msg = utf8;
      }
      Py_DECREF(s);
    }
  }
  if (type != nullptr) {
    if (PyObject *n = PyObject_GetAttrString(type, "__name__")) {
      if (const char *utf8 = PyUnicode_AsUTF8(n)) {
        msg = std::string(utf8) + ": " + msg;
      }
      Py_DECREF(n);
    } else {
      PyErr_Clear();
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  PyErr_Clear();
  set_error(msg);
}

// One-time interpreter + bridge-module setup. Returns a BORROWED bridge
// reference (kept alive for the process lifetime), or nullptr with the
// error slot set. Must be called with the GIL held — see EnsureGil.
PyObject *bridge() {
  static PyObject *mod = nullptr;  // never released: process-lifetime
  if (mod == nullptr) {
    mod = PyImport_ImportModule("parakeet_tpu_torch.capi");
    if (mod == nullptr) {
      set_error_from_python();
      return nullptr;
    }
  }
  return mod;
}

// RAII GIL acquisition, initializing the interpreter on first use when
// the host has none.
class EnsureGil {
 public:
  EnsureGil() {
    // Standalone (non-Python) host: bring up an interpreter once and
    // detach from it so PyGILState_Ensure works from any thread. The
    // once_flag serializes first calls racing from multiple host threads
    // (concurrent Py_InitializeEx is undefined behavior — no GIL exists
    // yet to order them).
    static std::once_flag init_once;
    std::call_once(init_once, [] {
      if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        PyEval_SaveThread();
      }
    });
    state_ = PyGILState_Ensure();
  }
  ~EnsureGil() { PyGILState_Release(state_); }
  EnsureGil(const EnsureGil &) = delete;
  EnsureGil &operator=(const EnsureGil &) = delete;

 private:
  PyGILState_STATE state_;
};

// Copy a Python str result out as a heap C string; nullptr on error.
char *to_c_string(PyObject *res) {
  if (res == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  const char *utf8 = PyUnicode_AsUTF8(res);
  if (utf8 == nullptr) {
    Py_DECREF(res);
    set_error_from_python();
    return nullptr;
  }
  char *out = strdup(utf8);
  Py_DECREF(res);
  if (out == nullptr) {
    set_error("out of memory");
  }
  return out;
}

char *transcribe_pcm_impl(int64_t handle, const void *pcm, int64_t n,
                          int64_t itemsize, int32_t rate, const char *fmt) {
  if (pcm == nullptr || n <= 0) {
    set_error("pcm buffer is null or empty");
    return nullptr;
  }
  EnsureGil gil;
  PyObject *mod = bridge();
  if (mod == nullptr) {
    return nullptr;
  }
  // Zero-copy view over the caller's buffer; the bridge copies out of it
  // (np.frombuffer -> resample/scale) before returning, so the view never
  // outlives this call.
  PyObject *view = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<void *>(pcm)),
      static_cast<Py_ssize_t>(n * itemsize), PyBUF_READ);
  if (view == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  PyObject *res = PyObject_CallMethod(mod, "transcribe_pcm", "LOis",
                                      static_cast<long long>(handle), view,
                                      static_cast<int>(rate), fmt);
  Py_DECREF(view);
  return to_c_string(res);
}

char *stream_feed_impl(int64_t handle, const void *pcm, int64_t n,
                       int64_t itemsize, const char *fmt) {
  if (pcm == nullptr || n <= 0) {
    set_error("pcm buffer is null or empty");
    return nullptr;
  }
  EnsureGil gil;
  PyObject *mod = bridge();
  if (mod == nullptr) {
    return nullptr;
  }
  PyObject *view = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<void *>(pcm)),
      static_cast<Py_ssize_t>(n * itemsize), PyBUF_READ);
  if (view == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  PyObject *res = PyObject_CallMethod(mod, "stream_feed", "LOs",
                                      static_cast<long long>(handle), view,
                                      fmt);
  Py_DECREF(view);
  return to_c_string(res);
}

}  // namespace

extern "C" {

int64_t parakeet_create(const char *model, const char *weights_path,
                        const char *vocab_path, const char *options_json) {
  if (model == nullptr) {
    set_error("model is required");
    return 0;
  }
  EnsureGil gil;
  PyObject *mod = bridge();
  if (mod == nullptr) {
    return 0;
  }
  // "z" maps nullptr -> None for the optional arguments
  PyObject *res = PyObject_CallMethod(mod, "create", "szzz", model,
                                      weights_path, vocab_path, options_json);
  if (res == nullptr) {
    set_error_from_python();
    return 0;
  }
  long long h = PyLong_AsLongLong(res);
  Py_DECREF(res);
  if (h <= 0 && PyErr_Occurred()) {
    set_error_from_python();
    return 0;
  }
  return static_cast<int64_t>(h);
}

char *parakeet_transcribe(int64_t handle, const char *audio_path) {
  if (audio_path == nullptr) {
    set_error("audio_path is required");
    return nullptr;
  }
  EnsureGil gil;
  PyObject *mod = bridge();
  if (mod == nullptr) {
    return nullptr;
  }
  PyObject *res = PyObject_CallMethod(mod, "transcribe", "Ls",
                                      static_cast<long long>(handle),
                                      audio_path);
  return to_c_string(res);
}

char *parakeet_transcribe_pcm(int64_t handle, const float *pcm,
                              int64_t num_samples, int32_t sample_rate) {
  return transcribe_pcm_impl(handle, pcm, num_samples,
                             static_cast<int64_t>(sizeof(float)), sample_rate,
                             "f32");
}

char *parakeet_transcribe_pcm_s16(int64_t handle, const int16_t *pcm,
                                  int64_t num_samples, int32_t sample_rate) {
  return transcribe_pcm_impl(handle, pcm, num_samples,
                             static_cast<int64_t>(sizeof(int16_t)),
                             sample_rate, "s16");
}

char *parakeet_align(int64_t handle, const char *audio_path,
                     const char *text) {
  if (audio_path == nullptr || text == nullptr) {
    set_error("audio_path and text are required");
    return nullptr;
  }
  EnsureGil gil;
  PyObject *mod = bridge();
  if (mod == nullptr) {
    return nullptr;
  }
  PyObject *res = PyObject_CallMethod(mod, "align", "Lss",
                                      static_cast<long long>(handle),
                                      audio_path, text);
  return to_c_string(res);
}

int64_t parakeet_diarize_create(const char *model, const char *asr_weights,
                                const char *sortformer_weights,
                                const char *vocab_path,
                                const char *options_json) {
  if (model == nullptr) {
    set_error("model is required");
    return 0;
  }
  EnsureGil gil;
  PyObject *mod = bridge();
  if (mod == nullptr) {
    return 0;
  }
  PyObject *res =
      PyObject_CallMethod(mod, "diarize_create", "szzzz", model, asr_weights,
                          sortformer_weights, vocab_path, options_json);
  if (res == nullptr) {
    set_error_from_python();
    return 0;
  }
  long long h = PyLong_AsLongLong(res);
  Py_DECREF(res);
  if (h <= 0 && PyErr_Occurred()) {
    set_error_from_python();
    return 0;
  }
  return static_cast<int64_t>(h);
}

char *parakeet_diarize(int64_t handle, const char *audio_path) {
  if (audio_path == nullptr) {
    set_error("audio_path is required");
    return nullptr;
  }
  EnsureGil gil;
  PyObject *mod = bridge();
  if (mod == nullptr) {
    return nullptr;
  }
  PyObject *res = PyObject_CallMethod(mod, "diarize", "Ls",
                                      static_cast<long long>(handle),
                                      audio_path);
  return to_c_string(res);
}

int64_t parakeet_stream_create(const char *model, const char *weights_path,
                               const char *vocab_path,
                               const char *options_json) {
  if (model == nullptr) {
    set_error("model is required");
    return 0;
  }
  EnsureGil gil;
  PyObject *mod = bridge();
  if (mod == nullptr) {
    return 0;
  }
  PyObject *res = PyObject_CallMethod(mod, "stream_create", "szzz", model,
                                      weights_path, vocab_path, options_json);
  if (res == nullptr) {
    set_error_from_python();
    return 0;
  }
  long long h = PyLong_AsLongLong(res);
  Py_DECREF(res);
  if (h <= 0 && PyErr_Occurred()) {
    set_error_from_python();
    return 0;
  }
  return static_cast<int64_t>(h);
}

char *parakeet_stream_feed(int64_t handle, const float *pcm,
                           int64_t num_samples) {
  return stream_feed_impl(handle, pcm, num_samples,
                          static_cast<int64_t>(sizeof(float)), "f32");
}

char *parakeet_stream_feed_s16(int64_t handle, const int16_t *pcm,
                               int64_t num_samples) {
  return stream_feed_impl(handle, pcm, num_samples,
                          static_cast<int64_t>(sizeof(int16_t)), "s16");
}

char *parakeet_stream_text(int64_t handle) {
  EnsureGil gil;
  PyObject *mod = bridge();
  if (mod == nullptr) {
    return nullptr;
  }
  PyObject *res = PyObject_CallMethod(mod, "stream_text", "L",
                                      static_cast<long long>(handle));
  return to_c_string(res);
}

void parakeet_stream_reset(int64_t handle) {
  EnsureGil gil;
  PyObject *mod = bridge();
  if (mod == nullptr) {
    return;
  }
  PyObject *res = PyObject_CallMethod(mod, "stream_reset", "L",
                                      static_cast<long long>(handle));
  if (res == nullptr) {
    set_error_from_python();
    return;
  }
  Py_DECREF(res);
}

void parakeet_destroy(int64_t handle) {
  EnsureGil gil;
  PyObject *mod = bridge();
  if (mod == nullptr) {
    return;
  }
  PyObject *res = PyObject_CallMethod(mod, "destroy", "L",
                                      static_cast<long long>(handle));
  if (res == nullptr) {
    set_error_from_python();
    return;
  }
  Py_DECREF(res);
}

const char *parakeet_last_error(void) { return g_last_error.c_str(); }

char *parakeet_version(void) {
  EnsureGil gil;
  PyObject *mod = bridge();
  if (mod == nullptr) {
    return nullptr;
  }
  PyObject *res = PyObject_CallMethod(mod, "version", nullptr);
  return to_c_string(res);
}

void parakeet_free_string(char *s) { free(s); }

}  // extern "C"
