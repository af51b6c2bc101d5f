// C ABI implementation: embeds CPython and forwards to the sassy_tpu_torch
// package (the reference exposes the same surface from its Rust cdylib,
// the reference's src/c.rs:52-131). The Searcher runs on the device named
// by SASSY_DEVICE, "cuda" by default; without a CUDA device its
// constructor raises, and sassy_searcher prints the error and returns NULL.
//
// Thread-safety: calls are serialized through the CPython GIL.

#include "sassy_tpu.h"

#include <Python.h>

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <mutex>

namespace {

std::once_flag g_init_once;

void ensure_python() {
  std::call_once(g_init_once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // release the GIL the initialising thread holds, so every call
      // (from any thread) takes it through PyGILState_Ensure
      PyEval_SaveThread();
    }
  });
}

struct Guard {
  PyGILState_STATE st;
  Guard() : st(PyGILState_Ensure()) {}
  ~Guard() { PyGILState_Release(st); }
};

}  // namespace

struct sassy_searcher {
  PyObject *obj;  // sassy_tpu_torch.Searcher
};

extern "C" sassy_searcher_t *sassy_searcher(const char *alphabet, int rc,
                                            double alpha) {
  ensure_python();
  Guard g;
  PyObject *mod = PyImport_ImportModule("sassy_tpu_torch");
  if (!mod) {
    PyErr_Print();
    return nullptr;
  }
  PyObject *cls = PyObject_GetAttrString(mod, "Searcher");
  Py_DECREF(mod);
  if (!cls) {
    PyErr_Print();
    return nullptr;
  }
  const char *device = std::getenv("SASSY_DEVICE");
  PyObject *args = Py_BuildValue("(s)", alphabet);
  PyObject *kw = Py_BuildValue("{s:O,s:s}", "rc", rc ? Py_True : Py_False,
                               "device", device && *device ? device : "cuda");
  if (args && kw && !std::isnan(alpha)) {
    PyObject *a = PyFloat_FromDouble(alpha);
    if (!a || PyDict_SetItemString(kw, "alpha", a) < 0) Py_CLEAR(kw);
    Py_XDECREF(a);
  }
  PyObject *inst = args && kw ? PyObject_Call(cls, args, kw) : nullptr;
  Py_DECREF(cls);
  Py_XDECREF(args);
  Py_XDECREF(kw);
  if (!inst) {
    PyErr_Print();
    return nullptr;
  }
  auto *s = static_cast<sassy_searcher_t *>(malloc(sizeof(sassy_searcher_t)));
  if (!s) {
    Py_DECREF(inst);
    return nullptr;
  }
  s->obj = inst;
  return s;
}

extern "C" size_t sassy_search(sassy_searcher_t *searcher,
                               const uint8_t *pattern, size_t pattern_len,
                               const uint8_t *text, size_t text_len, size_t k,
                               sassy_match_t **out) {
  if (!searcher || !out) return (size_t)-1;
  Guard g;
  PyObject *pat = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(pattern), (Py_ssize_t)pattern_len);
  PyObject *txt = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(text), (Py_ssize_t)text_len);
  PyObject *res = pat && txt ? PyObject_CallMethod(searcher->obj, "search",
                                                   "OOn", pat, txt,
                                                   (Py_ssize_t)k)
                             : nullptr;
  Py_XDECREF(pat);
  Py_XDECREF(txt);
  if (!res) {
    PyErr_Print();
    return (size_t)-1;
  }
  Py_ssize_t n = PyList_Size(res);
  if (n < 0) {
    PyErr_Print();
    Py_DECREF(res);
    return (size_t)-1;
  }
  auto *arr = static_cast<sassy_match_t *>(
      malloc(sizeof(sassy_match_t) * (n > 0 ? n : 1)));
  bool ok = arr != nullptr;
  for (Py_ssize_t i = 0; ok && i < n; i++) {
    PyObject *m = PyList_GetItem(res, i);  // borrowed
    auto geti = [&](const char *name) -> long long {
      PyObject *v = PyObject_GetAttrString(m, name);
      long long x = v ? PyLong_AsLongLong(v) : -1;
      Py_XDECREF(v);
      if (PyErr_Occurred()) ok = false;
      return x;
    };
    arr[i].text_start = (size_t)geti("text_start");
    arr[i].text_end = (size_t)geti("text_end");
    arr[i].pattern_start = (size_t)geti("pattern_start");
    arr[i].pattern_end = (size_t)geti("pattern_end");
    arr[i].cost = (int32_t)geti("cost");
    arr[i].strand = (uint8_t)geti("strand");
  }
  Py_DECREF(res);
  if (!ok) {
    if (PyErr_Occurred()) PyErr_Print();
    free(arr);
    return (size_t)-1;
  }
  *out = arr;
  return (size_t)n;
}

extern "C" void sassy_matches_free(sassy_match_t *matches, size_t n) {
  (void)n;
  free(matches);
}

extern "C" void sassy_searcher_free(sassy_searcher_t *searcher) {
  if (!searcher) return;
  {
    Guard g;
    Py_XDECREF(searcher->obj);
  }
  free(searcher);
}
