"""A layer's work per push (per tick in a served loop), for its roofline:
`work(run) -> (bytes, f32 operations)`, counted from the layer's own inputs
and outputs at the cell's shapes, each input byte read once and each output
byte written once, whatever kernel, fusion or launch shape does the work."""
