"""Process orchestration: TilerProcess, Tiler loop, ConverterProcess."""
