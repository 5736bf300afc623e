"""Native (host C++) runtime components of the port.

``scanner`` is the port's own copy of the reference's single-pass CSV
scanner (``scanner.cpp``), built with ``g++`` at first use into
``csvplus_tpu_torch/_build/`` and loaded with ``ctypes``.  A failed build
or load raises: the port never falls back to the Python parser because
the scanner is broken.
"""
