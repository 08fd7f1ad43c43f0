/* Single-core compiled-CPU wavefront BFS — the honest baseline.
 *
 * The port's own copy of stateright_tpu/native/bfs.cpp; the expansion
 * callback (stateright_tpu_torch/native/baseline.py) runs the port's
 * tensor twin as PyTorch on the CPU.
 *
 * The bench's `vs_baseline` used to divide device throughput by a pure-
 * Python thread BFS, which flatters the engine by however slow CPython is.
 * This is the compiled competitor (ROADMAP "compiled-CPU baseline"): the
 * SAME packed-row tensor model, expanded batch-wise through the same
 * `step_rows`/`property_masks` kernels (a Python callback supplied by
 * native/baseline.py), with the visited set and the FIFO work
 * queue — the parts the device engine implements as the bucketized HBM
 * table and the device queue — run natively on one core.
 *
 * Dedup is on the full row bytes (width * 8), not the 64-bit fingerprint:
 * exact, order-independent, and it needs no reimplementation of the
 * fingerprint chain in C++.  Unique counts therefore match the engines
 * modulo their accepted 2^-64 fingerprint-collision risk (pinned counts in
 * tests agree exactly on the bundled models).
 *
 * Exposed as _stateright_torch_native.bfs_run(expand, init, n_init, width,
 * arity, batch, target_unique); see the wrapper for the calling contract.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

struct BufferView {
    Py_buffer buf{};
    bool ok = false;

    bool acquire(PyObject* obj, const char* what, Py_ssize_t min_bytes) {
        if (PyObject_GetBuffer(obj, &buf, PyBUF_C_CONTIGUOUS) != 0) {
            return false;
        }
        ok = true;
        if (buf.len < min_bytes) {
            PyErr_Format(PyExc_ValueError, "%s buffer too small (%zd < %zd)",
                         what, buf.len, min_bytes);
            return false;
        }
        return true;
    }

    ~BufferView() {
        if (ok) PyBuffer_Release(&buf);
    }
};

}  // namespace

/* bfs_run(expand, init_rows, n_init, width, arity, batch, target_unique)
 *   -> (states, unique, wavefronts)
 *
 * expand:     callable(batch_bytes, k) -> (succ, valid); `batch_bytes` holds
 *             k C-contiguous u64 rows.  `succ` must expose >= k*arity*width
 *             u64 (C-contiguous buffer), `valid` >= k*arity bytes (bool8).
 *             Buffers may be padded past k rows; the tail is ignored.
 * init_rows:  buffer of n_init * width u64 (the packed init rows).
 * target_unique: stop at a clean batch boundary once unique >= target
 *             (0 = exhaust the space).
 *
 * states counts every generated (valid) successor plus all init rows, the
 * engines' scount convention; unique counts distinct rows.
 */
extern "C" PyObject* stateright_native_bfs_run(PyObject*, PyObject* args) {
    PyObject* expand;
    PyObject* init_obj;
    Py_ssize_t n_init, width, arity, batch;
    long long target;
    if (!PyArg_ParseTuple(args, "OOnnnnL", &expand, &init_obj, &n_init,
                          &width, &arity, &batch, &target))
        return nullptr;
    if (width <= 0 || arity <= 0 || batch <= 0 || n_init < 0) {
        PyErr_SetString(PyExc_ValueError, "bad bfs_run dimensions");
        return nullptr;
    }
    const size_t row_bytes = static_cast<size_t>(width) * 8;

    std::unordered_set<std::string> visited;
    std::deque<std::string> queue;
    long long states = 0, unique = 0, wavefronts = 0;

    {
        BufferView init;
        if (!init.acquire(init_obj, "init_rows",
                          n_init * static_cast<Py_ssize_t>(row_bytes)))
            return nullptr;
        const char* p = static_cast<const char*>(init.buf.buf);
        for (Py_ssize_t i = 0; i < n_init; ++i) {
            std::string key(p + i * row_bytes, row_bytes);
            ++states;  // scount counts all inits (engine parity)
            if (visited.insert(key).second) {
                ++unique;
                queue.push_back(std::move(key));
            }
        }
    }

    std::string batch_bytes;
    while (!queue.empty() && (target == 0 || unique < target)) {
        const Py_ssize_t k =
            static_cast<Py_ssize_t>(queue.size()) < batch
                ? static_cast<Py_ssize_t>(queue.size())
                : batch;
        batch_bytes.clear();
        batch_bytes.reserve(static_cast<size_t>(k) * row_bytes);
        for (Py_ssize_t i = 0; i < k; ++i) {
            batch_bytes.append(queue.front());
            queue.pop_front();
        }
        PyObject* arg_bytes = PyBytes_FromStringAndSize(
            batch_bytes.data(), static_cast<Py_ssize_t>(batch_bytes.size()));
        if (arg_bytes == nullptr) return nullptr;
        PyObject* res =
            PyObject_CallFunction(expand, "On", arg_bytes, k);
        Py_DECREF(arg_bytes);
        if (res == nullptr) return nullptr;
        PyObject *succ_obj, *valid_obj;
        if (!PyArg_ParseTuple(res, "OO", &succ_obj, &valid_obj)) {
            Py_DECREF(res);
            return nullptr;
        }
        {
            BufferView succ, valid;
            if (!succ.acquire(succ_obj, "succ",
                              k * arity * static_cast<Py_ssize_t>(row_bytes))
                || !valid.acquire(valid_obj, "valid", k * arity)) {
                Py_DECREF(res);
                return nullptr;
            }
            const char* sp = static_cast<const char*>(succ.buf.buf);
            const unsigned char* vp =
                static_cast<const unsigned char*>(valid.buf.buf);
            for (Py_ssize_t i = 0; i < k * arity; ++i) {
                if (!vp[i]) continue;
                ++states;
                std::string key(sp + static_cast<size_t>(i) * row_bytes,
                                row_bytes);
                if (visited.insert(key).second) {
                    ++unique;
                    queue.push_back(std::move(key));
                }
            }
        }
        Py_DECREF(res);
        ++wavefronts;
    }

    return Py_BuildValue("LLL", states, unique, wavefronts);
}
