"""The host plan of that conversion (partition pointer, page plan, packed
codes, window maps), from the program's own record of its phases
(``ops/convert.py::last_convert_phases``)."""


def read(t):
    return t.convert_phases.get("plan")
