"""The runtime layer: engine sets and the compile cache (``engine.py``),
the device an embedded caller asks for (``platform.py``) and the Python side
of the C-ABI bridge (``capi_bridge.py``)."""
