"""Model zoo of the port: the dense GQA decoder and RWKV-6 (other families follow)."""
