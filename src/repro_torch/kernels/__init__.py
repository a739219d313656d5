"""The flash-decode kernel (CUDA C++ for sm_90a), its plain version and the model-layout wrapper."""
