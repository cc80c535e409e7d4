"""Image IO and the KITTI submission protocol (numpy only)."""
