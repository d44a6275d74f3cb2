"""Host-side native code of the port (counterpart of ``clearvae_tpu/native``):
the KSG MI estimator in C++, built with g++ at first use."""
