"""The entries that serve a traffic mix (each mix's `entry`): `Entry(run)`
with `setup()` and `execute(request, keeper) -> harness.Record`."""
