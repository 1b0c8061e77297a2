"""The port's own copy of ``fluidframework_tpu/protocol/marker_plane.py`` (no JAX in it).

The marker codepoint plane: a wire-level encoding contract.

Markers are encoded as single codepoints in the Unicode private-use plane
``U+E000..U+F8FF`` (see dds/markers.py for the full design note).  The
plane boundaries are a CONTRACT shared by both sides of the stack — the
host marker registry (dds layer) and the device text-pool materializer
(ops layer) must agree on it or marker-ness silently leaks into user text.
It therefore lives here in ``protocol`` (base layer) where both import it
downward; it used to live in dds/markers.py, which made the text kernel an
upward importer (fftpu-check rule ``layer-upward-import``).
"""

MARKER_CP_BASE = 0xE000
MARKER_CP_END = 0xF900  # exclusive
