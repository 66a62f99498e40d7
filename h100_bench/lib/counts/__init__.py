"""Operations and bytes of the work the program launches, from shapes
alone, one module a kernel family. Each operation is counted once (a
multiply-add is two), each input byte read once and each output byte
written once, whatever the kernel reads again or however it splits its
products."""
