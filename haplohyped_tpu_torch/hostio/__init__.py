"""Host I/O: VCF framing (native ``cpp/hostio.cpp`` or pure Python)."""
