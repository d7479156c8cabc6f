"""Serialization: the reference's wire-compatible protobuf schemas and the
converters between their messages and the port's containers
(`quadrotorilqr_tpu/io/`).

The `*_pb2.py` modules are verbatim copies of the JAX package's, and
`protos/*.proto` its schemas (the same proto file names, the same proto
package `quadrotorilqr_tpu.proto`, the same fields; only the header
comments name the reference's files without their paths); `ilqr_debug_pb2`
keeps its package-relative import of `trajectory_pb2`. Both packages' modules add the same serialized
file to protobuf's default descriptor pool, which accepts an identical
file twice: imported side by side they resolve to one descriptor and one
set of message classes, so a message made by one package is an instance of
the other's types. A renamed proto package would make them different
types; the same file name with different content would clash in the pool.
Regenerate both copies together (`protoc --proto_path=protos --python_out=.
protos/*.proto`, then restore the relative import in `ilqr_debug_pb2.py`).

This is the only part of the port that imports `google.protobuf`; the API
imports it only when a proto is passed in or `solve` is called.
"""

from . import ilqr_debug_pb2, ilqr_options_pb2, trajectory_pb2
from .proto import (
    debug_from_proto,
    debug_to_proto,
    options_from_proto,
    options_to_proto,
    trajectory_from_proto,
    trajectory_to_proto,
)

__all__ = [
    "trajectory_pb2",
    "ilqr_options_pb2",
    "ilqr_debug_pb2",
    "trajectory_to_proto",
    "trajectory_from_proto",
    "options_to_proto",
    "options_from_proto",
    "debug_to_proto",
    "debug_from_proto",
]
