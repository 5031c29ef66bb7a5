"""Cross-bank exchange rounds the mesh kernel made on a tile's slowest
row, averaged over the window's mesh tiles (the backend's
``kernel_rounds`` counter)."""


def read(ctx):
    tiles = ctx.backend_tiles("colskip_mesh")
    if tiles <= 0:
        return None
    return (ctx.marks["close"]["mesh_rounds"]
            - ctx.marks["open"]["mesh_rounds"]) / tiles
