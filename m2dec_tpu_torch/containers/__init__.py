"""Container demuxers (host-side IO front ends)."""
