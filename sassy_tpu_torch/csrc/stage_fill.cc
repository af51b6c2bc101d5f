// The staged upload's host fill (ops/myers_torch.py ``_fill``): bytes
// c0 .. c1 - 1 of the concatenation of a list of one-dimensional byte
// buffers (numpy arrays, reversed views, bytes) into one output buffer, on
// several threads, with the interpreter lock released while they copy.
//
// Host C++, built with g++ against the running Python's headers
// (``gxx.build``) and loaded with ``ctypes.PyDLL``: the entry point is
// called with the interpreter lock held, takes each text's buffer
// (``PyObject_GetBuffer``), lets go of the lock for the copies and takes
// it back to release the buffers.

#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// one text: element i at src + i * stride (stride -1: a reversed view)
struct Part {
    const uint8_t* src;
    Py_ssize_t stride;
};

// bytes a .. b - 1 of the concatenation (texts t0 .. t1 - 1, text t from
// offs[t]) into out, whose byte 0 is concatenation byte c0
void copy_share(const Part* parts, const int64_t* offs, int64_t t0,
                int64_t t1, int64_t a, int64_t b, int64_t c0, uint8_t* out) {
    int64_t t = std::upper_bound(offs + t0, offs + t1, a) - offs - 1;
    for (; t < t1 && offs[t] < b; ++t) {
        int64_t lo = std::max(a, offs[t]), hi = std::min(b, offs[t + 1]);
        if (hi <= lo) continue;
        const Part& p = parts[t - t0];
        uint8_t* dst = out + (lo - c0);
        int64_t i0 = lo - offs[t], n = hi - lo;
        if (p.stride == 1) {
            std::memcpy(dst, p.src + i0, static_cast<size_t>(n));
        } else {
            const uint8_t* src = p.src + i0 * p.stride;
            for (int64_t k = 0; k < n; ++k) dst[k] = src[k * p.stride];
        }
    }
}

}  // namespace

// texts: a list of n buffers; offs: (n + 1,) int64, text t from byte
// offs[t] of the concatenation; out: c1 - c0 bytes. Copies on up to
// max_threads threads, no more than the texts the range holds, each an
// equal contiguous share of the bytes. Returns the threads used, or -1
// with a Python exception set.
extern "C" int sassy_stage_fill(PyObject* texts, const int64_t* offs,
                                int64_t c0, int64_t c1, uint8_t* out,
                                int max_threads) {
    Py_ssize_t n = PyList_Size(texts);
    if (n < 0) return -1;
    if (c0 < 0 || c1 > offs[n] || c1 <= c0) {
        PyErr_SetString(PyExc_ValueError, "byte range outside the texts");
        return -1;
    }
    int64_t t0 = std::upper_bound(offs, offs + n + 1, c0) - offs - 1;
    int64_t t1 = std::lower_bound(offs, offs + n + 1, c1) - offs;
    std::vector<Py_buffer> views(t1 - t0);
    std::vector<Part> parts(t1 - t0);
    int64_t held = 0;
    int rc = 0;
    for (int64_t t = t0; t < t1; ++t) {
        Py_buffer& v = views[held];
        if (PyObject_GetBuffer(PyList_GET_ITEM(texts, t), &v,
                               PyBUF_STRIDED_RO) < 0) {
            rc = -1;
            break;
        }
        ++held;
        if (v.ndim != 1 || v.itemsize != 1 || v.len != offs[t + 1] - offs[t]) {
            PyErr_Format(PyExc_ValueError,
                         "text %lld is not a 1-D byte buffer of its length",
                         static_cast<long long>(t));
            rc = -1;
            break;
        }
        parts[t - t0] = {static_cast<const uint8_t*>(v.buf), v.strides[0]};
    }
    if (rc == 0) {
        int threads = static_cast<int>(
            std::max<int64_t>(1, std::min<int64_t>(max_threads, t1 - t0)));
        rc = threads;
        Py_BEGIN_ALLOW_THREADS
        std::vector<std::thread> pool;
        for (int j = 1; j < threads; ++j) {
            int64_t a = c0 + (c1 - c0) * j / threads;
            int64_t b = c0 + (c1 - c0) * (j + 1) / threads;
            pool.emplace_back(copy_share, parts.data(), offs, t0, t1, a, b,
                              c0, out);
        }
        copy_share(parts.data(), offs, t0, t1, c0,
                   c0 + (c1 - c0) / threads, c0, out);
        for (auto& th : pool) th.join();
        Py_END_ALLOW_THREADS
    }
    for (int64_t i = 0; i < held; ++i) PyBuffer_Release(&views[i]);
    return rc;
}
