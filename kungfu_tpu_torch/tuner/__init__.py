"""The tuner (counterpart of kungfu_tpu.tuner): so far only the footprint
default of the chunked head's vocab block (`footprint.default_ce_block`).
The rest of the tuner is ROADMAP A.8.  Imports nothing heavy."""
