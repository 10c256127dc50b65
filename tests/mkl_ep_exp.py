"""A pytest plugin that plants a less accurate float32 exponential: every
float32 ``torch.exp`` on a CPU tensor goes through MKL VML's ``vsExp`` in
its enhanced-performance mode (``VML_EP``, relative error up to ~4e-5)
instead of the high-accuracy mode PyTorch asks for.  Other dtypes and
devices go through ``torch.exp`` as they are.

It shows whether a plain version's result depends on the float32
exponential's accuracy: the RG-LRU's ``1 - exp(2·log_a)`` cancels near
log_a = 0 and magnifies that error up to 500× on the parity tests'
inputs.  Run from the repository root with a PyTorch built with MKL::

    PYTHONPATH=src:tests python -m pytest -p mkl_ep_exp -p no:randomly \\
        tests/test_torch_recurrent.py -k rglru

The summary line counts the exponentials that took the planted path."""
import ctypes
import os

import numpy as np
import torch

VML_EP = 0x3
_exp = torch.exp
_calls = [0]


def _vsexp():
    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libtorch_cpu.so"))
    f = lib.VMSEXP_                  # MKL's Fortran entry: n, a, y, mode
    f.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
    return f


_f = _vsexp()


def ep_exp(t, *args, **kwargs):
    if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32
            and t.device.type == "cpu" and not args and not kwargs):
        return _exp(t, *args, **kwargs)
    v = np.ascontiguousarray(t.detach().numpy())
    out = np.empty_like(v)
    n, mode = ctypes.c_int(v.size), ctypes.c_longlong(VML_EP)
    _f(ctypes.byref(n), v.ctypes.data, out.ctypes.data, ctypes.byref(mode))
    _calls[0] += 1
    return torch.from_numpy(out)


torch.exp = ep_exp


def pytest_terminal_summary(terminalreporter):
    terminalreporter.write_line(
        f"mkl_ep_exp: {_calls[0]} float32 exponentials in VML_EP mode")
