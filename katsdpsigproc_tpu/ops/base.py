"""Operation framework: composable shape-specialized pure functions.

The reference composes GPU kernels through an Operation / IOSlot / Dimension
graph that propagates buffer padding constraints and aliases scratch memory
(reference: src/katsdpsigproc/accel.py:1115-1960).  Under XLA, fusion and
buffer assignment subsume padding unification and scratch aliasing, so this
design keeps the reference's *workflow* — build a template once,
instantiate per shape, bind buffers, call — but each instantiated operation
is a **pure jitted function** over named arrays:

* a :class:`Slot` declares a named input or output as a
  ``jax.ShapeDtypeStruct`` (the analogue of ``IOSlot``,
  accel.py:1379-1502);
* an :class:`Operation` owns slots plus a pure ``_run(**inputs) -> outputs``
  (the analogue of ``Operation``, accel.py:1611-1756) and is callable either
  functionally (``out = op(a=x)``) or via the reference's bind-then-call
  style;
* :class:`OperationSequence` chains operations by slot wiring and jits the
  whole chain as ONE XLA program, so intermediate buffers never round-trip
  to device memory when XLA can fuse them (the analogue of ``OperationSequence``'s
  compound/alias slots, accel.py:1759-1835);
* :func:`visualize_operation` emits Graphviz DOT for the slot graph
  (accel.py:1935-1960).
"""

import enum
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import shapes as shapes_util


class Direction(enum.Enum):
    IN = "in"
    OUT = "out"


class Dimension:
    """Padding/alignment requirement for one axis of a :class:`Slot`.

    The reference's ``Dimension`` (accel.py:1115-1294) propagates padding
    requirements between composed kernels through union-find linking.
    Under XLA the compiler owns the *physical* layout, so what survives is the
    reference's user-visible contract: operations declare requirements
    (``min_padded_round`` / ``min_padded_size``, power-of-2 ``alignment``,
    ``exact``), composition LINKS the dimensions of slots that share a
    buffer — merging requirements and failing fast on unsatisfiable
    combinations — and binding a buffer freezes the requirement.  The
    GPU stride hint (``align_dtype`` / ``ALIGN_BYTES``) has no analogue:
    the tile contract in :mod:`..utils.shapes` plays that
    role and is applied by :attr:`Slot.padded_shape`.
    """

    @staticmethod
    def _is_power2(value: int) -> bool:
        return value > 0 and (value & (value - 1)) == 0

    def __init__(self, size: int, min_padded_round: Optional[int] = None,
                 min_padded_size: Optional[int] = None, alignment: int = 1,
                 exact: bool = False) -> None:
        if min_padded_size is None:
            if min_padded_round is not None:
                min_padded_size = -(-size // min_padded_round) * min_padded_round
            else:
                min_padded_size = size
        if not self._is_power2(alignment):
            raise ValueError("alignment is not a power of 2")
        if min_padded_size < size:
            raise ValueError("padded size is less than size")
        self._parent: Optional["Dimension"] = None
        self._size = int(size)
        self._min_padded_size = int(min_padded_size)
        self._alignment = int(alignment)
        self._exact = bool(exact)
        self._frozen = False

    def _root(self) -> "Dimension":
        if self._parent is None:
            return self
        self._parent = self._parent._root()  # path compression
        return self._parent

    @property
    def size(self) -> int:
        return self._root()._size

    @property
    def exact(self) -> bool:
        return self._root()._exact

    @property
    def frozen(self) -> bool:
        return self._root()._frozen

    def required_padded_size(self) -> int:
        """Smallest padded size satisfying this requirement
        (reference accel.py:1224-1232, minus the GPU stride hint)."""
        root = self._root()
        a = root._alignment
        return -(-root._min_padded_size // a) * a

    def valid(self, padded_size: int) -> bool:
        """Whether `padded_size` satisfies the requirement (accel.py:1234-1240)."""
        root = self._root()
        if root._exact:
            return padded_size == root.required_padded_size()
        return (padded_size >= root._min_padded_size
                and padded_size % root._alignment == 0)

    def link(self, other: "Dimension") -> None:
        """Share one requirement between `self` and `other`
        (union-find merge; reference accel.py:1256-1290).

        Raises ``ValueError`` if either is frozen, the sizes differ, or an
        ``exact`` requirement cannot satisfy the other's constraints.
        """
        root1, root2 = self._root(), other._root()
        if root1 is root2:
            return
        if root1._frozen or root2._frozen:
            raise ValueError("cannot link frozen requirements")
        if root1._size != root2._size:
            raise ValueError("sizes are incompatible")
        for exact_root, other_root in ((root1, root2), (root2, root1)):
            if exact_root._exact and not other_root.valid(
                    exact_root.required_padded_size()):
                raise ValueError("linked requirement is unsatisfiable")
        root1._min_padded_size = max(root1._min_padded_size, root2._min_padded_size)
        root1._alignment = max(root1._alignment, root2._alignment)
        root1._exact = root1._exact or root2._exact
        root2._parent = root1

    def freeze(self) -> None:
        """Prevent further modification (done on buffer bind,
        reference accel.py:1292-1294 / 1444-1450)."""
        self._root()._frozen = True


class Slot:
    """A named buffer requirement on an operation.

    Parameters
    ----------
    shape
        Logical (unpadded) shape.
    dtype
        Element type.
    direction
        Whether the operation consumes or produces this buffer.
    pad_value
        Value with which padding (up to the tile grid) may be filled.
        The reference leaves padding undefined (doc/user/buffers.rst:26-31);
        here it is explicit so rank/reduction kernels can rely on it.
    """

    def __init__(self, shape: Sequence[int], dtype, direction: Direction, pad_value=0,
                 dimensions: Optional[Sequence[Dimension]] = None):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = jnp.dtype(dtype)
        self.direction = direction
        self.pad_value = pad_value
        if dimensions is None:
            dimensions = [Dimension(s) for s in self.shape]
        else:
            dimensions = list(dimensions)
            if len(dimensions) != len(self.shape):
                raise ValueError("wrong number of dimensions")
            for s, d in zip(self.shape, dimensions):
                if d.size != s:
                    raise ValueError(
                        f"dimension size {d.size} does not match shape entry {s}")
        self.dimensions: Tuple[Dimension, ...] = tuple(dimensions)

    @property
    def struct(self) -> jax.ShapeDtypeStruct:
        return jax.ShapeDtypeStruct(self.shape, self.dtype)

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        """Per-axis max of the tile contract and any linked
        :class:`Dimension` requirements (exact dimensions pin the size)."""
        base = shapes_util.padded_shape(self.shape, self.dtype)
        out = []
        for b, d in zip(base, self.dimensions):
            req = d.required_padded_size()
            out.append(req if d.exact else max(b, req))
        return tuple(out)

    def required_bytes(self) -> int:
        n = 1
        for s in self.padded_shape:
            n *= s
        return n * self.dtype.itemsize

    def validate(self, array) -> None:
        if tuple(array.shape) != self.shape:
            raise ValueError(f"expected shape {self.shape}, got {tuple(array.shape)}")
        if jnp.dtype(array.dtype) != self.dtype:
            raise TypeError(f"expected dtype {self.dtype}, got {array.dtype}")

    def __repr__(self) -> str:  # pragma: nocover
        return f"Slot({self.shape}, {self.dtype}, {self.direction.value})"


class Operation:
    """A shape-specialized accelerated operation.

    Subclasses populate ``self.slots`` and implement :meth:`_run` as a pure
    function mapping input arrays (by slot name) to a dict of output arrays
    (by slot name).  ``_run`` is traced and compiled once per shape set.

    Two calling conventions are supported:

    * **functional** — ``outputs = op(vis=x)`` returns a dict of outputs;
    * **bound** — ``op.bind(vis=x); op(); out = op.buffer("deviations")``,
      mirroring the reference workflow (doc/user/operations.rst:116-145).
    """

    def __init__(self) -> None:
        self.slots: Dict[str, Slot] = {}
        self._bound: Dict[str, Any] = {}
        self._jitted: Optional[Callable] = None
        self._trace_version = 0

    # -- abstract ---------------------------------------------------------
    def _run(self, **inputs):
        """Pure computation: input arrays by slot name → dict of outputs."""
        raise NotImplementedError  # pragma: nocover

    # -- introspection ----------------------------------------------------
    def input_slots(self) -> Dict[str, Slot]:
        return {k: s for k, s in self.slots.items() if s.direction == Direction.IN}

    def output_slots(self) -> Dict[str, Slot]:
        return {k: s for k, s in self.slots.items() if s.direction == Direction.OUT}

    def required_bytes(self) -> int:
        """Total buffer footprint (reference: accel.py:1736-1738)."""
        return sum(s.required_bytes() for s in self.slots.values())

    def parameters(self) -> Mapping[str, Any]:
        """Configuration dump (reference: accel.py:1740-1742)."""
        return {}

    # -- execution --------------------------------------------------------
    def invalidate(self) -> None:
        """Drop the compiled trace (call after mutating state that `_run`
        bakes in, e.g. :meth:`..fill.Fill.set_value`).  Parent sequences
        notice via :meth:`_trace_state` and re-trace too."""
        self._trace_version += 1
        self._jitted = None

    def _trace_state(self):
        return self._trace_version

    def _compiled(self) -> Callable:
        state = self._trace_state()
        if self._jitted is None or getattr(self, "_jitted_state", None) != state:
            self._jitted = jax.jit(lambda inputs: self._run(**inputs))
            self._jitted_state = state
        return self._jitted

    def bind(self, **arrays) -> None:
        """Attach arrays to slots (reference: accel.py:1676-1690).

        Binding freezes the slot's dimensions, as the reference does
        (accel.py:1444-1450): requirement changes after a buffer exists
        would invalidate it.
        """
        for name, array in arrays.items():
            if name not in self.slots:
                raise KeyError(f"no slot named {name!r}")
            self.slots[name].validate(array)
            for d in self.slots[name].dimensions:
                d.freeze()
            self._bound[name] = array

    def ensure_all_bound(self) -> None:
        """Allocate zeroed arrays for EVERY unbound slot (accel.py:1692-1696).

        The reference allocates output slots too, so ``buffer(name)`` is
        usable before the first call; calling the operation then replaces
        the placeholder with the computed array.
        """
        for name, slot in self.slots.items():
            if name not in self._bound:
                self._bound[name] = jnp.zeros(slot.shape, slot.dtype)

    def buffer(self, name: str):
        """Return the array bound to (or produced for) `name` (accel.py:1698-1712)."""
        return self._bound[name]

    def __call__(self, **inputs):
        if inputs:
            in_slots = self.input_slots()
            for name in in_slots:
                if name not in inputs:
                    raise KeyError(f"missing input {name!r}")
            for name in inputs:
                if name not in in_slots:
                    raise KeyError(f"unknown input {name!r}")
            outputs = self._compiled()({k: inputs[k] for k in in_slots})
            return outputs
        # Bound style: consume bound inputs, store outputs for buffer().
        self.ensure_all_bound()
        outputs = self._compiled()({k: self._bound[k] for k in self.input_slots()})
        self._bound.update(outputs)
        return outputs


class OperationSequence(Operation):
    """Compose child operations into one jitted program.

    Parameters
    ----------
    operations
        Ordered ``(name, operation)`` pairs (reference accel.py:1785).
    compounds
        Mapping of sequence-level slot name → list of ``"child:slot"``
        strings that all refer to the same buffer (the analogue of
        ``CompoundIOSlot`` dimension linking, accel.py:1802-1809).  Children
        execute in order; a compound written by an earlier child feeds later
        children reading it.
    unwired
        By default, child slots not mentioned in `compounds` are exposed as
        ``"child:slot"`` (reference naming, accel.py:1800-1801).
    """

    def __init__(
        self,
        operations: Sequence[Tuple[str, Operation]],
        compounds: Optional[Mapping[str, Sequence[str]]] = None,
    ) -> None:
        super().__init__()
        self.operations = list(operations)
        self.compounds = {k: list(v) for k, v in (compounds or {}).items()}
        self._child_by_name = dict(self.operations)
        if len(self._child_by_name) != len(self.operations):
            raise ValueError("duplicate child operation names")

        # Map each child slot to a sequence-level name.
        self._alias: Dict[Tuple[str, str], str] = {}
        for seq_name, members in self.compounds.items():
            for member in members:
                child, slot = member.split(":", 1)
                if child not in self._child_by_name:
                    raise KeyError(f"unknown child {child!r} in compound {seq_name!r}")
                if slot not in self._child_by_name[child].slots:
                    raise KeyError(f"child {child!r} has no slot {slot!r}")
                self._alias[(child, slot)] = seq_name

        # Build sequence-level slots. A compound is IN if some child reads it
        # before any child writes it; OUT if any child writes it.
        produced: set = set()
        for child_name, child in self.operations:
            for slot_name, slot in child.slots.items():
                seq_name = self._alias.get(
                    (child_name, slot_name), f"{child_name}:{slot_name}"
                )
                if slot.direction == Direction.IN and seq_name in produced:
                    # Reading a buffer produced by an earlier child: shapes
                    # must agree (CompoundIOSlot contract, accel.py:1544-1546)
                    # and the padding requirements merge (Dimension.link).
                    existing = self.slots[seq_name]
                    if existing.shape != slot.shape or existing.dtype != slot.dtype:
                        raise ValueError(
                            f"compound slot {seq_name!r} mismatch: "
                            f"{existing.shape}/{existing.dtype} vs {slot.shape}/{slot.dtype}"
                        )
                    self._link_dims(seq_name, existing, slot)
                elif slot.direction == Direction.IN:
                    if seq_name not in self.slots:
                        self.slots[seq_name] = Slot(
                            slot.shape, slot.dtype, Direction.IN, slot.pad_value,
                            dimensions=slot.dimensions,
                        )
                    else:
                        # Shape/dtype agreement across a compound
                        # (CompoundIOSlot requires equal shapes, accel.py:1544-1546)
                        existing = self.slots[seq_name]
                        if existing.shape != slot.shape or existing.dtype != slot.dtype:
                            raise ValueError(
                                f"compound slot {seq_name!r} mismatch: "
                                f"{existing.shape}/{existing.dtype} vs {slot.shape}/{slot.dtype}"
                            )
                        self._link_dims(seq_name, existing, slot)
                elif slot.direction == Direction.OUT:
                    produced.add(seq_name)
                    if seq_name in self.slots:
                        self._link_dims(seq_name, self.slots[seq_name], slot)
                    self.slots[seq_name] = Slot(
                        slot.shape, slot.dtype, Direction.OUT, slot.pad_value,
                        dimensions=slot.dimensions,
                    )

    @staticmethod
    def _link_dims(seq_name: str, a: "Slot", b: "Slot") -> None:
        """Union-find merge of two compound members' axis requirements
        (the CompoundIOSlot → Dimension.link chain, accel.py:1544-1546 →
        1256-1290); unsatisfiable combinations fail at composition time."""
        for axis, (da, db) in enumerate(zip(a.dimensions, b.dimensions)):
            try:
                da.link(db)
            except ValueError as exc:
                raise ValueError(
                    f"compound slot {seq_name!r} axis {axis}: {exc}") from None

    def _run(self, **inputs):
        env: Dict[str, Any] = dict(inputs)
        for child_name, child in self.operations:
            child_inputs = {}
            for slot_name in child.input_slots():
                seq_name = self._alias.get((child_name, slot_name), f"{child_name}:{slot_name}")
                child_inputs[slot_name] = env[seq_name]
            child_outputs = child._run(**child_inputs)
            for slot_name, value in child_outputs.items():
                seq_name = self._alias.get((child_name, slot_name), f"{child_name}:{slot_name}")
                env[seq_name] = value
        return {name: env[name] for name, slot in self.output_slots().items() if name in env}

    def _trace_state(self):
        return (self._trace_version,) + tuple(
            op._trace_state() for _, op in self.operations
        )

    def required_bytes(self) -> int:
        # Sequence-level view only: intermediates are XLA's to alias.
        return sum(s.required_bytes() for s in self.slots.values())

    def parameters(self) -> Mapping[str, Any]:
        return {name: op.parameters() for name, op in self.operations}


def visualize_operation(op: Operation) -> str:
    """Render the operation/slot graph as Graphviz DOT text.

    Reference: accel.py:1935-1960 (which requires the graphviz package;
    here the DOT source is returned for the caller to render).
    """
    lines = ["digraph operation {", "  rankdir=LR;"]
    ops: List[Tuple[str, Operation]]
    if isinstance(op, OperationSequence):
        ops = op.operations
    else:
        ops = [("op", op)]
    for op_name, child in ops:
        lines.append(f'  "{op_name}" [shape=box,label="{op_name}\\n{type(child).__name__}"];')
    seen = set()
    for op_name, child in ops:
        for slot_name, slot in child.slots.items():
            seq_name = (
                op._alias.get((op_name, slot_name), f"{op_name}:{slot_name}")
                if isinstance(op, OperationSequence)
                else slot_name
            )
            if seq_name not in seen:
                seen.add(seq_name)
                label = f"{seq_name}\\n{slot.shape} {slot.dtype}\\npadded {slot.padded_shape}"
                lines.append(f'  "slot:{seq_name}" [shape=ellipse,label="{label}"];')
            if slot.direction == Direction.IN:
                lines.append(f'  "slot:{seq_name}" -> "{op_name}";')
            else:
                lines.append(f'  "{op_name}" -> "slot:{seq_name}";')
    lines.append("}")
    return "\n".join(lines)


def as_output(name: str, array) -> Dict[str, Any]:
    """Convenience for single-output ``_run`` implementations."""
    return {name: array}
