"""Buffer-meta keys shared by the modules that stamp or read them.

Port of ``nnstreamer_tpu/core/meta_keys.py``, cut to the keys the static
LLM stream path uses.  Pure constants, no imports.
"""

#: 0-based index of a streamed response chunk within its request
META_STREAM_INDEX = "stream_index"
#: final chunk of a streamed response (True on exactly one buffer)
META_STREAM_LAST = "stream_last"
