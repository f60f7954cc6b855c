"""Operations and bytes from shapes: a kernel's (one file each) and the
whole step's model FLOPs.  The kernels' arithmetic is ``chip_smoke.py``'s
kernel phase (flash: 4 x B x H x hd per (query, key) pair the mask keeps;
bucket copies: every byte read once and written once); a roofline share
is ``max(ops / peak FLOP/s, bytes / peak bytes/s)`` over the kernel's
traced time."""
