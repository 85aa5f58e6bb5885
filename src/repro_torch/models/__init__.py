# Model zoo for decode serving; only the dense family is ported (see registry).
