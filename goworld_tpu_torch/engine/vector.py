"""3-vector used for entity positions (reference:
reference engine/entity/Vector3.go).  AOI operates on the X-Z plane.

Hot-path note: one Vector3 is constructed per set_position per entity per
tick, so this is a plain ``__slots__`` class -- the earlier frozen-dataclass
version (3 ``object.__setattr__`` + 3 float32 casts) cost ~1.2 us per
construction and dominated the engine tick's host time.  Components are
plain floats; float32 quantization happens where it matters bit-for-bit, at
the AOI array boundary (Space's packed f32 arrays)."""

from __future__ import annotations

import math


class Vector3:
    __slots__ = ("x", "y", "z")

    def __init__(self, x: float = 0.0, y: float = 0.0, z: float = 0.0):
        self.x = float(x)
        self.y = float(y)
        self.z = float(z)

    def __repr__(self) -> str:
        return f"Vector3({self.x}, {self.y}, {self.z})"

    def __eq__(self, o) -> bool:
        return (isinstance(o, Vector3) and self.x == o.x and self.y == o.y
                and self.z == o.z)

    def __hash__(self) -> int:
        return hash((self.x, self.y, self.z))

    def distance_to(self, o: "Vector3") -> float:
        return math.sqrt(
            (self.x - o.x) ** 2 + (self.y - o.y) ** 2 + (self.z - o.z) ** 2
        )

    def add(self, o: "Vector3") -> "Vector3":
        return Vector3(self.x + o.x, self.y + o.y, self.z + o.z)

    def sub(self, o: "Vector3") -> "Vector3":
        return Vector3(self.x - o.x, self.y - o.y, self.z - o.z)

    def scale(self, s: float) -> "Vector3":
        return Vector3(self.x * s, self.y * s, self.z * s)

    def normalized(self) -> "Vector3":
        d = math.sqrt(self.x**2 + self.y**2 + self.z**2)
        if d == 0:
            return Vector3()
        return self.scale(1.0 / d)

    def dir_to_yaw(self) -> float:
        """Yaw (degrees) of this direction on the X-Z plane."""
        return math.degrees(math.atan2(self.x, self.z))

    def to_tuple(self):
        return (self.x, self.y, self.z)
