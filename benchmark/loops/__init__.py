"""The general loops of a window. A traffic mix (`benchmark/traffic/*.json`)
names one and gives its parameters; each module has `run(ctx)` returning a
`common.Record`."""
