"""Host C++ of the port, built with g++ into the package's ``_build/``
directory (``gxx``): the native wire-ingest encoder (``ingest.cpp``, bound
by ``ingest_native``) and the native deli sequencer (``sequencer.cpp``,
bound by ``sequencer_native``; the exports are the reference
``native/__init__.py``'s)."""

from .sequencer_native import NativeSequencer, native_available

__all__ = ["NativeSequencer", "native_available"]
