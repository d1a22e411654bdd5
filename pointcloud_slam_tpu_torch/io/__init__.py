"""Host-side IO (numpy): the sensor feed, synthetic data, PCD files, ROS1 bags
(with their LZ4 chunks), point-cloud format converters and external odometry
feeds, producing tensors for the device."""

from . import converters, feed, lz4, odom_feed, pcd, rosbag, synthetic

__all__ = ["converters", "feed", "lz4", "odom_feed", "pcd", "rosbag", "synthetic"]
