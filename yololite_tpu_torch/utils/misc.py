"""Small helpers the predict path needs (the part of yololite_tpu/utils/misc.py it uses)."""

from __future__ import annotations


class SimpleClass:
    """Base giving subclasses a readable attribute-dump str/repr and a helpful
    missing-attribute error. Results and Boxes inherit it."""

    def __str__(self):
        attrs = []
        for a in dir(self):
            v = getattr(self, a)
            if not callable(v) and not a.startswith("_"):
                if isinstance(v, SimpleClass):
                    s = f"{a}: {v.__module__}.{v.__class__.__name__} object"
                else:
                    s = f"{a}: {v!r}"
                attrs.append(s)
        return f"{self.__module__}.{self.__class__.__name__} object with attributes:\n\n" + "\n".join(attrs)

    def __repr__(self):
        return self.__str__()

    def __getattr__(self, attr):
        name = self.__class__.__name__
        raise AttributeError(f"'{name}' object has no attribute '{attr}'. See valid attributes below.\n{self.__doc__}")

