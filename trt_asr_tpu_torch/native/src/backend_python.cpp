// Torch backend: embeds CPython and drives the trt_asr_tpu_torch runtime
// through trt_asr_tpu_torch/runtime/capi_bridge.py. This is the
// native<->PyTorch seam replacing the reference's TensorRT engine calls:
// the C++ shell owns buffering/events/ABI, Python owns the model and its
// CUDA kernels. The device is the bridge's: the card unless the
// environment asks for the CPU (JAX_PLATFORMS=cpu); without a card and
// without that request, session creation fails.
#include "backend.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <mutex>
#include <string>

namespace trt_asr {

namespace {

std::once_flag g_py_init_once;

void ensure_python() {
    std::call_once(g_py_init_once, [] {
        if (!Py_IsInitialized()) {
            Py_InitializeEx(0);
            // release the GIL acquired by Py_Initialize so PyGILState_Ensure
            // works from any caller thread
            PyEval_SaveThread();
        }
    });
}

struct Gil {
    PyGILState_STATE st;
    Gil() : st(PyGILState_Ensure()) {}
    ~Gil() { PyGILState_Release(st); }
};

std::string py_err_string() {
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    std::string msg = "python error";
    if (value) {
        PyObject* s = PyObject_Str(value);
        if (s) {
            msg = PyUnicode_AsUTF8(s);
            Py_DECREF(s);
        }
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
    return msg;
}

class PythonBackend final : public Backend {
  public:
    ~PythonBackend() override {
        if (session_) {
            Gil g;
            call1("destroy_session", session_);
            Py_CLEAR(session_);
            Py_CLEAR(bridge_);
        }
    }

    bool init(const std::string& model_dir, std::string& err) override {
        ensure_python();
        Gil g;
        bridge_ = PyImport_ImportModule("trt_asr_tpu_torch.runtime.capi_bridge");
        if (!bridge_) {
            err = "import capi_bridge failed: " + py_err_string() +
                  " (is PYTHONPATH set to the repository root, with torch importable?)";
            return false;
        }
        PyObject* r = PyObject_CallMethod(bridge_, "create_session", "s",
                                          model_dir.c_str());
        if (!r) {
            err = "create_session failed: " + py_err_string();
            return false;
        }
        session_ = r;
        {
            PyObject* m = PyObject_CallMethod(bridge_, "n_mels", "O", session_);
            if (m) {
                n_mels_ = static_cast<int>(PyLong_AsLong(m));
                Py_DECREF(m);
            } else {
                PyErr_Clear();
            }
        }
        return true;
    }

    void reset_utterance() override {
        Gil g;
        call1("reset_session", session_);
    }

    bool push_features(const float* feats_tc, size_t frames, std::string& err) override {
        Gil g;
        PyObject* mv = PyMemoryView_FromMemory(
            reinterpret_cast<char*>(const_cast<float*>(feats_tc)),
            static_cast<Py_ssize_t>(frames * static_cast<size_t>(n_mels_) * sizeof(float)),
            PyBUF_READ);
        if (!mv) {
            err = py_err_string();
            return false;
        }
        PyObject* r = PyObject_CallMethod(bridge_, "push_features", "OOn", session_,
                                          mv, static_cast<Py_ssize_t>(frames));
        Py_DECREF(mv);
        if (!r) {
            err = "push_features failed: " + py_err_string();
            return false;
        }
        Py_DECREF(r);
        return true;
    }

    bool finalize(std::string& err) override {
        Gil g;
        PyObject* r = PyObject_CallMethod(bridge_, "finalize", "O", session_);
        if (!r) {
            err = "finalize failed: " + py_err_string();
            return false;
        }
        Py_DECREF(r);
        return true;
    }

    bool poll(BackendEvent& ev) override {
        Gil g;
        PyObject* r = PyObject_CallMethod(bridge_, "poll_event", "O", session_);
        if (!r) {
            PyErr_Clear();
            return false;
        }
        if (r == Py_None) {
            Py_DECREF(r);
            return false;
        }
        // (type:int, segment:int, text:str, error:str)
        int type = 0, seg = 0;
        const char *text = nullptr, *error = nullptr;
        if (PyArg_ParseTuple(r, "iiss", &type, &seg, &text, &error)) {
            ev.type = type;
            ev.segment_id = seg;
            ev.text = text ? text : "";
            ev.error = error ? error : "";
            Py_DECREF(r);
            return true;
        }
        PyErr_Clear();
        Py_DECREF(r);
        return false;
    }

    std::string info() const override { return "backend=torch(embedded)"; }
    int n_mels() const override { return n_mels_; }

    std::string stable_text() override {
        Gil g;
        PyObject* r = PyObject_CallMethod(bridge_, "stable_text", "O",
                                          session_);
        if (!r) {
            PyErr_Clear();
            return "";
        }
        const char* s = PyUnicode_AsUTF8(r);
        if (!s) PyErr_Clear();
        std::string out = s ? s : "";
        Py_DECREF(r);
        return out;
    }

    std::string word_timestamps_tsv() override {
        Gil g;
        PyObject* r = PyObject_CallMethod(bridge_, "word_timestamps_tsv", "O",
                                          session_);
        if (!r) {
            PyErr_Clear();
            return "";
        }
        const char* s = PyUnicode_AsUTF8(r);
        if (!s) PyErr_Clear();   // non-str / bad UTF-8: must not leave a
                                 // pending exception for the next C-API call
        std::string out = s ? s : "";
        Py_DECREF(r);
        return out;
    }

  private:
    void call1(const char* name, PyObject* arg) {
        PyObject* r = PyObject_CallMethod(bridge_, name, "O", arg);
        if (r) {
            Py_DECREF(r);
        } else {
            PyErr_Clear();
        }
    }

    PyObject* bridge_ = nullptr;
    PyObject* session_ = nullptr;
    int n_mels_ = 128;
};

}  // namespace

Backend* make_python_backend() { return new PythonBackend(); }

}  // namespace trt_asr
