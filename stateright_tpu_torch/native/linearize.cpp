/* Native linearizability / sequential-consistency search for register-like
 * histories — the host-side hot path of consistency checking.
 *
 * The port's own copy of stateright_tpu/native/linearize.cpp, built into
 * the port's module `_stateright_torch_native` (a name of its own, so both
 * packages' modules load side by side in one process).
 *
 * The checker evaluates the `linearizable` property on every state
 * (reference runs the equivalent Rust search per state,
 * src/semantics/linearizability.rs:178-240); on CPU execution paths this
 * dominates the profile, so the exhaustive interleaving search is
 * implemented natively.  Semantics mirror the Python `_serialize` in
 * stateright_tpu_torch/semantics/linearizability.py exactly:
 *
 *  - completed ops are serialized respecting per-thread program order;
 *  - each op carries "last completed" prerequisites (peer, index) that must
 *    already be serialized before it (the real-time constraint; dropped for
 *    sequential consistency);
 *  - an in-flight op per thread may be serialized or skipped;
 *  - register semantics: writes always succeed, a read must return the
 *    current register value.
 *
 * Ops are passed as flat int arrays (thread-indexed), values as small ints
 * mapped by the Python caller.  Exposed as
 * _stateright_torch_native.serialize_register(...).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <vector>

/* bfs.cpp: the single-core compiled-CPU wavefront baseline (both sources
 * compile into this one module; see native/build.py). */
extern "C" PyObject* stateright_native_bfs_run(PyObject*, PyObject*);

namespace {

constexpr int KIND_WRITE = 0;
constexpr int KIND_READ = 1;

struct Op {
    int kind;
    int value;      // write: value written; read: value returned (completed)
    bool has_ret;   // completed ops have returns; in-flight do not
    std::vector<std::pair<int, int>> prereq;  // (thread, min index) pairs
};

struct Thread {
    std::vector<Op> completed;  // program order
    bool has_inflight = false;
    Op inflight;
};

struct Search {
    std::vector<Thread> threads;
    bool real_time;

    // next completed index to serialize, per thread
    std::vector<size_t> next;
    std::vector<bool> inflight_done;

    bool violates(const Op& op) const {
        if (!real_time) return false;
        for (auto& [peer, min_idx] : op.prereq) {
            // a prerequisite is violated if that peer still has an
            // unserialized completed op with index <= min_idx
            if (next[peer] <= static_cast<size_t>(min_idx)) return true;
        }
        return false;
    }

    bool all_serialized() const {
        for (size_t t = 0; t < threads.size(); ++t)
            if (next[t] < threads[t].completed.size()) return false;
        return true;
    }

    bool run(int reg_value) {
        if (all_serialized()) return true;  // in-flight may stay unserialized
        for (size_t t = 0; t < threads.size(); ++t) {
            Thread& th = threads[t];
            if (next[t] < th.completed.size()) {
                // case 2: this thread's next completed op
                const Op& op = th.completed[next[t]];
                if (violates(op)) continue;
                int next_reg = reg_value;
                if (op.kind == KIND_WRITE) {
                    next_reg = op.value;
                } else if (op.value != reg_value) {
                    continue;  // read must return the register's value
                }
                ++next[t];
                if (run(next_reg)) return true;
                --next[t];
            } else if (th.has_inflight && !inflight_done[t]) {
                // case 1: an in-flight op with no observed return; its
                // return is unconstrained, so reads never fail here
                const Op& op = th.inflight;
                if (violates(op)) continue;
                int next_reg =
                    (op.kind == KIND_WRITE) ? op.value : reg_value;
                inflight_done[t] = true;
                if (run(next_reg)) return true;
                inflight_done[t] = false;
            }
        }
        return false;
    }
};

/* Parse one op tuple: (kind, value, prereq_tuple) where prereq_tuple is
 * ((peer, idx), ...). */
bool parse_op(PyObject* obj, Op& op, bool completed) {
    if (!PyTuple_Check(obj) || PyTuple_GET_SIZE(obj) != 3) {
        PyErr_SetString(PyExc_TypeError, "op must be (kind, value, prereqs)");
        return false;
    }
    op.kind = static_cast<int>(PyLong_AsLong(PyTuple_GET_ITEM(obj, 0)));
    op.value = static_cast<int>(PyLong_AsLong(PyTuple_GET_ITEM(obj, 1)));
    op.has_ret = completed;
    PyObject* prereqs = PyTuple_GET_ITEM(obj, 2);
    if (!PyTuple_Check(prereqs)) {
        PyErr_SetString(PyExc_TypeError, "prereqs must be a tuple");
        return false;
    }
    Py_ssize_t n = PyTuple_GET_SIZE(prereqs);
    op.prereq.reserve(static_cast<size_t>(n));
    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject* pair = PyTuple_GET_ITEM(prereqs, i);
        if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) != 2) {
            PyErr_SetString(PyExc_TypeError, "prereq must be (peer, idx)");
            return false;
        }
        op.prereq.emplace_back(
            static_cast<int>(PyLong_AsLong(PyTuple_GET_ITEM(pair, 0))),
            static_cast<int>(PyLong_AsLong(PyTuple_GET_ITEM(pair, 1))));
    }
    return !PyErr_Occurred();
}

/* serialize_register(threads, init_value, real_time) -> bool
 *
 * threads: tuple over threads; each thread is
 *   (completed_ops_tuple, inflight_op_or_None)
 * where each op is (kind, value, prereqs) with values already mapped to
 * small ints by the caller; a completed read's `value` is its returned
 * value. Thread ids in prereqs index this tuple.
 */
PyObject* serialize_register(PyObject*, PyObject* args) {
    PyObject* threads_obj;
    int init_value, real_time;
    if (!PyArg_ParseTuple(args, "Oip", &threads_obj, &init_value, &real_time))
        return nullptr;
    if (!PyTuple_Check(threads_obj)) {
        PyErr_SetString(PyExc_TypeError, "threads must be a tuple");
        return nullptr;
    }
    Search s;
    s.real_time = real_time != 0;
    Py_ssize_t nt = PyTuple_GET_SIZE(threads_obj);
    s.threads.resize(static_cast<size_t>(nt));
    for (Py_ssize_t t = 0; t < nt; ++t) {
        PyObject* th = PyTuple_GET_ITEM(threads_obj, t);
        if (!PyTuple_Check(th) || PyTuple_GET_SIZE(th) != 2) {
            PyErr_SetString(PyExc_TypeError,
                            "thread must be (completed, inflight)");
            return nullptr;
        }
        PyObject* completed = PyTuple_GET_ITEM(th, 0);
        if (!PyTuple_Check(completed)) {
            PyErr_SetString(PyExc_TypeError, "completed must be a tuple");
            return nullptr;
        }
        Py_ssize_t nc = PyTuple_GET_SIZE(completed);
        s.threads[t].completed.resize(static_cast<size_t>(nc));
        for (Py_ssize_t i = 0; i < nc; ++i) {
            if (!parse_op(PyTuple_GET_ITEM(completed, i),
                          s.threads[t].completed[i], true))
                return nullptr;
        }
        PyObject* inflight = PyTuple_GET_ITEM(th, 1);
        if (inflight != Py_None) {
            s.threads[t].has_inflight = true;
            if (!parse_op(inflight, s.threads[t].inflight, false))
                return nullptr;
        }
    }
    s.next.assign(s.threads.size(), 0);
    s.inflight_done.assign(s.threads.size(), false);
    bool ok;
    Py_BEGIN_ALLOW_THREADS
    ok = s.run(init_value);
    Py_END_ALLOW_THREADS
    if (ok) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

PyMethodDef methods[] = {
    {"serialize_register", serialize_register, METH_VARARGS,
     "Exhaustive register-history serialization search. Returns True iff a "
     "legal total order exists."},
    {"bfs_run", stateright_native_bfs_run, METH_VARARGS,
     "Single-core wavefront BFS over packed u64 rows (bfs.cpp): native "
     "visited set + FIFO queue around a batch-expansion callback. Returns "
     "(states, unique, wavefronts)."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_stateright_torch_native",
    "Native hot paths for stateright_tpu_torch (consistency search, "
    "compiled-CPU BFS baseline).", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__stateright_torch_native(void) {
    return PyModule_Create(&moduledef);
}
