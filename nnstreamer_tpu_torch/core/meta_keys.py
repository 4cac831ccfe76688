"""Buffer-meta keys shared by the modules that stamp or read them.

Port of ``nnstreamer_tpu/core/meta_keys.py``, cut to the keys the LLM
stream paths use (static and continuous).  Pure constants, no imports.
"""

#: continuous-serving stream identity (minted at submit, on every token)
META_STREAM_ID = "stream_id"
#: 0-based index of a streamed response chunk within its request
META_STREAM_INDEX = "stream_index"
#: final chunk of a streamed response (True on exactly one buffer)
META_STREAM_LAST = "stream_last"
#: typed terminator: the stream ended abnormally (pair with abort reason)
META_STREAM_ABORTED = "stream_aborted"
#: why a stream was aborted (the policy that fired)
META_ABORT_REASON = "abort_reason"
#: monotonic seconds at which a streamed token left the serve loop
META_EMIT_T = "emit_t"
