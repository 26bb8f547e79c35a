"""NVIDIA H100 SXM constants for the planner and the estimator, from NVIDIA's
H100 Tensor Core GPU data sheet (dense rates, no sparsity, 700 W part).

Port-only: ``core/notation.py`` stays a copy of the JAX package's, with its
A100 and TPU figures. Pass these through ``planner.plan_config(link_bw=,
host_bw=, hbm_bytes=)`` and ``planner.cost_model_for(peak_per_chip=)``, or
``launch.plan --chip h100 --link nvlink4``; ``chip_smoke.py`` reckons its
kernels' bounds from them. The HBM size needs no constant
of its own: 80 GB, as for the A100-80G (``launch.plan --hbm-gb 80``).
"""
H100_PEAK_BF16 = 989e12        # bf16 dense tensor-core FLOP/s
H100_PEAK_FP32 = 67e12         # fp32 FLOP/s outside the tensor cores
H100_HBM_BW = 3.35e12          # HBM3 bytes/s
H100_NVLINK_BW = 450e9         # NVLink 4: 900 GB/s both ways, per direction
H100_PCIE_BW = 64e9            # PCIe Gen5 x16: 128 GB/s both ways, per
#                                direction (the data sheet's figure, before
#                                protocol overhead; chip_smoke.py prints a
#                                measured pinned D2H rate beside it)
