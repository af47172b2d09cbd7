// The KServe-v2 responses that the C++ gRPC examples read, as small
// hand-written classes in place of protoc's: the same namespace, class
// names and accessors, so an example written against the generated
// messages compiles unedited.  Each class keeps only the fields its
// accessors return: MergeFromString (kserve_wire.cc) decodes them by
// their field numbers in proto/inference.proto and model_config.proto and
// skips every other field, as protobuf skips unknown ones; a singular
// message field seen twice merges, a scalar's last value wins, a map key
// seen again replaces its value.  ParseFromString clears first, as
// protobuf's does.
//
// No protobuf and no CUDA header is included: the client and its
// examples build with g++ alone.
#pragma once

#include <cstdint>
#include <map>
#include <string>
#include <string_view>
#include <vector>

namespace inference {

// ServerMetadataResponse: name 1, version 2.
class ServerMetadataResponse {
 public:
  const std::string& name() const { return name_; }
  const std::string& version() const { return version_; }
  bool ParseFromString(std::string_view bytes)
  {
    *this = ServerMetadataResponse();
    return MergeFromString(bytes);
  }
  bool MergeFromString(std::string_view bytes);

 private:
  std::string name_;
  std::string version_;
};

// ModelMetadataResponse: name 1, inputs 4, outputs 5, each a
// TensorMetadata (name 1, datatype 2, shape 3).
class ModelMetadataResponse {
 public:
  class TensorMetadata {
   public:
    const std::string& name() const { return name_; }
    const std::string& datatype() const { return datatype_; }
    const std::vector<int64_t>& shape() const { return shape_; }
    bool ParseFromString(std::string_view bytes)
    {
      *this = TensorMetadata();
      return MergeFromString(bytes);
    }
    bool MergeFromString(std::string_view bytes);

   private:
    std::string name_;
    std::string datatype_;
    std::vector<int64_t> shape_;
  };

  const std::string& name() const { return name_; }
  int inputs_size() const { return static_cast<int>(inputs_.size()); }
  int outputs_size() const { return static_cast<int>(outputs_.size()); }
  const TensorMetadata& inputs(int i) const { return inputs_.at(i); }
  const TensorMetadata& outputs(int i) const { return outputs_.at(i); }
  bool ParseFromString(std::string_view bytes)
  {
    *this = ModelMetadataResponse();
    return MergeFromString(bytes);
  }
  bool MergeFromString(std::string_view bytes);

 private:
  std::string name_;
  std::vector<TensorMetadata> inputs_;
  std::vector<TensorMetadata> outputs_;
};

// ModelConfig (model_config.proto): max_batch_size 4.
class ModelConfig {
 public:
  int32_t max_batch_size() const { return max_batch_size_; }
  bool ParseFromString(std::string_view bytes)
  {
    *this = ModelConfig();
    return MergeFromString(bytes);
  }
  bool MergeFromString(std::string_view bytes);

 private:
  int32_t max_batch_size_ = 0;
};

// ModelConfigResponse: config 1.
class ModelConfigResponse {
 public:
  const ModelConfig& config() const { return config_; }
  bool ParseFromString(std::string_view bytes)
  {
    *this = ModelConfigResponse();
    return MergeFromString(bytes);
  }
  bool MergeFromString(std::string_view bytes);

 private:
  ModelConfig config_;
};

// RepositoryIndexResponse: models 1 (counted, not kept).
class RepositoryIndexResponse {
 public:
  int models_size() const { return models_size_; }
  bool ParseFromString(std::string_view bytes)
  {
    *this = RepositoryIndexResponse();
    return MergeFromString(bytes);
  }
  bool MergeFromString(std::string_view bytes);

 private:
  int models_size_ = 0;
};

// StatisticDuration: count 1.
class StatisticDuration {
 public:
  uint64_t count() const { return count_; }
  bool ParseFromString(std::string_view bytes)
  {
    *this = StatisticDuration();
    return MergeFromString(bytes);
  }
  bool MergeFromString(std::string_view bytes);

 private:
  uint64_t count_ = 0;
};

// InferStatistics: success 1.
class InferStatistics {
 public:
  const StatisticDuration& success() const { return success_; }
  bool ParseFromString(std::string_view bytes)
  {
    *this = InferStatistics();
    return MergeFromString(bytes);
  }
  bool MergeFromString(std::string_view bytes);

 private:
  StatisticDuration success_;
};

// ModelStatistics: name 1, inference_stats 6.
class ModelStatistics {
 public:
  const std::string& name() const { return name_; }
  const InferStatistics& inference_stats() const { return inference_stats_; }
  bool ParseFromString(std::string_view bytes)
  {
    *this = ModelStatistics();
    return MergeFromString(bytes);
  }
  bool MergeFromString(std::string_view bytes);

 private:
  std::string name_;
  InferStatistics inference_stats_;
};

// ModelStatisticsResponse: model_stats 1.
class ModelStatisticsResponse {
 public:
  const std::vector<ModelStatistics>& model_stats() const
  {
    return model_stats_;
  }
  bool ParseFromString(std::string_view bytes)
  {
    *this = ModelStatisticsResponse();
    return MergeFromString(bytes);
  }
  bool MergeFromString(std::string_view bytes);

 private:
  std::vector<ModelStatistics> model_stats_;
};

// SystemSharedMemoryStatusResponse: regions 1, a map from the region's
// name to its RegionStatus (name 1, key 2, offset 3, byte_size 4).
class SystemSharedMemoryStatusResponse {
 public:
  class RegionStatus {
   public:
    const std::string& name() const { return name_; }
    const std::string& key() const { return key_; }
    uint64_t offset() const { return offset_; }
    uint64_t byte_size() const { return byte_size_; }
    bool ParseFromString(std::string_view bytes)
    {
      *this = RegionStatus();
      return MergeFromString(bytes);
    }
    bool MergeFromString(std::string_view bytes);

   private:
    std::string name_;
    std::string key_;
    uint64_t offset_ = 0;
    uint64_t byte_size_ = 0;
  };

  const std::map<std::string, RegionStatus>& regions() const
  {
    return regions_;
  }
  bool ParseFromString(std::string_view bytes)
  {
    *this = SystemSharedMemoryStatusResponse();
    return MergeFromString(bytes);
  }
  bool MergeFromString(std::string_view bytes);

 private:
  std::map<std::string, RegionStatus> regions_;
};

// CudaSharedMemoryStatusResponse: regions 1, a map from the region's
// name to its RegionStatus (name 1, device_id 2, byte_size 3).
class CudaSharedMemoryStatusResponse {
 public:
  class RegionStatus {
   public:
    const std::string& name() const { return name_; }
    uint64_t device_id() const { return device_id_; }
    uint64_t byte_size() const { return byte_size_; }
    bool ParseFromString(std::string_view bytes)
    {
      *this = RegionStatus();
      return MergeFromString(bytes);
    }
    bool MergeFromString(std::string_view bytes);

   private:
    std::string name_;
    uint64_t device_id_ = 0;
    uint64_t byte_size_ = 0;
  };

  const std::map<std::string, RegionStatus>& regions() const
  {
    return regions_;
  }
  bool ParseFromString(std::string_view bytes)
  {
    *this = CudaSharedMemoryStatusResponse();
    return MergeFromString(bytes);
  }
  bool MergeFromString(std::string_view bytes);

 private:
  std::map<std::string, RegionStatus> regions_;
};

}  // namespace inference
