"""On-disk formats the port reads and writes: cameras, images and masks,
vis.dat, .patch/.pset and .ply (copies of the JAX package's jax-free
`io` modules, kept in the port so that it imports nothing of that
package)."""
