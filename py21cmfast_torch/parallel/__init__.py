"""Multi-GPU runs over `torch.distributed`: one process a rank, each on its
own x-slab of every grid (SPMD).  `mesh` holds the process group and every
collective, `multihost` the initialization, `pfft` the slab FFT, `perturb`
the sharded ICs and perturbed field, `halopaint` and `sampler` the discrete
halos, `shardcall` the seam of the model scans, and `driver` the sharded
coeval and lightcone.  `import py21cmfast_torch` does not import this
package.
"""
