"""What one job of a traffic mix runs, an entry a file, found by the
mix's `entry` name (spec.load_module).  Each entry gives:

  setup(config, mix, libs, device, spans) -> state   (warm-up included)
  job(state, lib, spans) -> (output, least)     one timed job on libs[lib]
  reads(state, lib) -> reads of one job
  release(state, kept) -> judged                host copies, program freed
  check(config, mix, libs, judged, device, control=None) -> checks
"""
