"""Model layers of the port (paged serving path of plain-GQA decoders)."""
