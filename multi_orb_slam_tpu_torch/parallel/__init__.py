"""Multi-host layer over `torch.distributed`: the counterpart of
`multi_orb_slam_tpu/parallel/` (`multihost`, `dist_ba`, `dist_placerec`),
plus `dryrun`, the counterpart of the reference's multi-chip dry run."""
