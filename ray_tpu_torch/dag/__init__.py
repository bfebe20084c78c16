"""Token streams between processes: `stream.py` (the shared-memory
StreamRing) and `push_stream.py` (the same record contract over rpc), which
Serve uses to carry a replica's streamed output to the proxy.

Counterpart: ray_tpu/dag/__init__.py, of which the compiled DAG (InputNode,
compile, the stage loops) is not ported yet; it comes with the pipelined
engine.
"""
