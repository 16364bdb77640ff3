"""Core value types — the port of ``byteps_tpu/common/types.py``:
``DataType``, ``Status``, ``QueueType``, ``RequestType``,
``get_command_type`` and ``TensorTaskEntry``.

Counterpart of reference ``byteps/common/common.h``.  Each ``DataType``
member carries its torch dtype here (the JAX package's carries a numpy
one), and :meth:`DataType.from_dtype` takes torch dtypes as well as the
numpy and string spellings.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import torch


class DataType(enum.IntEnum):
    """Wire dtype enum; ordering follows reference common.h:39-52."""

    FLOAT32 = 0
    FLOAT64 = 1
    FLOAT16 = 2
    UINT8 = 3
    INT32 = 4
    INT8 = 5
    INT64 = 6
    BFLOAT16 = 7   # the JAX package's addition, kept for wire parity

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self]

    @property
    def itemsize(self) -> int:
        return self.torch_dtype.itemsize

    @staticmethod
    def from_dtype(dtype) -> "DataType":
        """A torch dtype, a numpy dtype or a name (``"bfloat16"``)."""
        name = str(dtype)
        if isinstance(dtype, torch.dtype):
            name = name.split(".", 1)[1]
        elif not isinstance(dtype, str) and name != "bfloat16":
            import numpy as np

            name = np.dtype(dtype).name
        try:
            return _FROM_NAME[name]
        except KeyError as e:
            raise ValueError(f"unsupported dtype {dtype!r}") from e


_TORCH_DTYPES = {
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64,
    DataType.FLOAT16: torch.float16,
    DataType.UINT8: torch.uint8,
    DataType.INT32: torch.int32,
    DataType.INT8: torch.int8,
    DataType.INT64: torch.int64,
    DataType.BFLOAT16: torch.bfloat16,
}

_FROM_NAME = {str(d).split(".", 1)[1]: k for k, d in _TORCH_DTYPES.items()}


class StatusType(enum.IntEnum):
    """Reference common.h:57-66."""

    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    IN_PROGRESS = 5


@dataclass(frozen=True)
class Status:
    """Reference common.h:57-108 — a tiny result type for the handle API."""

    type: StatusType = StatusType.OK
    reason: str = ""

    @staticmethod
    def OK() -> "Status":
        return Status(StatusType.OK)

    @staticmethod
    def InProgress() -> "Status":
        return Status(StatusType.IN_PROGRESS)

    @staticmethod
    def UnknownError(msg: str) -> "Status":
        return Status(StatusType.UNKNOWN_ERROR, msg)

    @staticmethod
    def PreconditionError(msg: str) -> "Status":
        return Status(StatusType.PRECONDITION_ERROR, msg)

    @staticmethod
    def Aborted(msg: str) -> "Status":
        return Status(StatusType.ABORTED, msg)

    @staticmethod
    def InvalidArgument(msg: str) -> "Status":
        return Status(StatusType.INVALID_ARGUMENT, msg)

    def ok(self) -> bool:
        return self.type == StatusType.OK

    def in_progress(self) -> bool:
        return self.type == StatusType.IN_PROGRESS


class QueueType(enum.IntEnum):
    """Pipeline stages; reference common.h:68-80.  The eager engine tags
    each task with the stages it logically passes, so traces read in the
    reference's vocabulary; the coordinate stages are where the port's
    ranks agree on an issue order (engine/dispatcher.py)."""

    COORDINATE_REDUCE = 0
    REDUCE = 1
    COPYD2H = 2
    PCIE_REDUCE = 3
    COORDINATE_PUSH = 4
    PUSH = 5
    PULL = 6
    COPYH2D = 7
    COORDINATE_BROADCAST = 8
    BROADCAST = 9


class RequestType(enum.IntEnum):
    """Reference common.h:212-218."""

    DEFAULT_PUSH_PULL = 0
    ROW_SPARSE_PUSH_PULL = 1
    COMPRESSED_PUSH_PULL = 2


def get_command_type(request: RequestType, dtype: DataType) -> int:
    """Cantor pairing of (request, dtype) — reference common.cc:98-101."""
    x, y = int(request), int(dtype)
    return (x + y) * (x + y + 1) // 2 + y


@dataclass
class TensorTaskEntry:
    """The unit of scheduled work — counterpart of ``TensorTableEntry``
    (reference common.h:170-209).

    One declared tensor is split into >=1 partitions (reference
    operations.cc:95-132); each partition is one TensorTaskEntry sharing
    the parent's ``total_partitions`` countdown."""

    name: str
    key: int
    priority: int = 0
    version: int = 0
    offset: int = 0  # byte offset of this partition in the parent tensor
    length: int = 0  # byte length of this partition
    total_partitions: int = 1
    partition_index: int = 0
    queue_list: list = field(default_factory=list)
    # engine-facing fields: the partition's flat view of the caller's
    # contribution, the collective's output, the per-tensor callback
    payload: object = None
    output: object = None
    callback: Optional[object] = None
    counter_ref: Optional[list] = None  # shared [int] across partitions
