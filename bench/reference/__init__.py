"""The plain reference: NumPy in float64 over the float32-snapped store.

It imports nothing of the program. ``geometry`` decides each relation and
the point distance for one (window, record) pair per row; ``search`` finds
the candidates of a window or a point through its own grid over the record
MBRs and gives the answers; ``precision`` rounds a store and its queries to
bfloat16 for the control.
"""
