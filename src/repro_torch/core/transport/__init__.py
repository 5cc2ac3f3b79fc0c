"""Wire framing shared with the reference (PROTOCOL_VERSION 3)."""
