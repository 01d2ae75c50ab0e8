"""Command-line tools (reference src/app parity: m2dec, h264dec,
threadplayer), with Phase B on the card by default."""
