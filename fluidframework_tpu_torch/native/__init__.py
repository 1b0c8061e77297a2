"""Host C++ of the port: the native wire-ingest encoder (``ingest.cpp``,
bound by ``ingest_native``), built with g++ into the package's
``_build/`` directory."""
