"""The port's native C-ABI runtime: C++ sources (``include/``, ``src/``,
``cli/``, ``tools/``) of ``libtrt_asr_tpu_torch.so``, ``trt_asr_cli``,
``logmel_tool`` and ``abi_thread_smoke``, and the helper that builds them
(``build.py``). The library's Python backend embeds CPython and drives
``trt_asr_tpu_torch.runtime.capi_bridge``."""
